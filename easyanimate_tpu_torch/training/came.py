"""CAME optimizer (Confidence-guided Adaptive Memory Efficient, Luo et al.
2023) as a gradient transformation over {name: tensor} dicts.

Parity: easyanimate_tpu/training/came.py (reference `--use_came`,
train.py:1195-1203, came_pytorch.CAME). Second moments and the confidence
statistics are rank-1 factored for >= 2-D parameters (Adafactor-style row
and column means over the last two axes), so the state is ~n floats (the
first moment) plus rows and columns, not 2n extra.

Per step (paper Alg. 1):
  u    = g / sqrt(vhat)        vhat: factored EMA of g^2 + eps1
  uhat = u / max(1, RMS(u)/d)  update clipping
  m    = b1 m + (1-b1) uhat
  s    = (uhat - m)^2          instability
  update = m / sqrt(shat)      shat: factored EMA of s + eps2
came(lr) emits -lr * update. State tensors are updated in place.
"""
from typing import NamedTuple

import torch

from .optim import GradientTransformation, Params


class Factored(NamedTuple):
    row: torch.Tensor
    col: torch.Tensor
    full: torch.Tensor  # used when rank < 2 (shape () placeholder otherwise)


class CAMEState(NamedTuple):
    count: int
    m: Params
    v: dict  # name -> Factored
    s: dict  # name -> Factored


def _init_factored(p: torch.Tensor) -> Factored:
    z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
    if p.dim() >= 2:
        return Factored(z(p.shape[:-1]), z(p.shape[:-2] + p.shape[-1:]), z(()))
    return Factored(z(()), z(()), z(p.shape))


def _update_factored(fac: Factored, sq: torch.Tensor, beta: float) -> None:
    if sq.dim() >= 2:
        fac.row.mul_(beta).add_(sq.mean(dim=-1), alpha=1 - beta)
        fac.col.mul_(beta).add_(sq.mean(dim=-2), alpha=1 - beta)
    else:
        fac.full.mul_(beta).add_(sq, alpha=1 - beta)


def _approx(fac: Factored, ndim: int) -> torch.Tensor:
    if ndim >= 2:
        denom = fac.row.mean(dim=-1, keepdim=True)[..., None]
        return fac.row[..., None] * fac.col[..., None, :] / denom.clamp_min(1e-30)
    return fac.full


def came(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         b3: float = 0.9999, eps1: float = 1e-30, eps2: float = 1e-16,
         clip_threshold: float = 1.0,
         weight_decay: float = 0.0) -> GradientTransformation:
    def init(params):
        return CAMEState(
            count=0,
            m={k: torch.zeros_like(p, dtype=torch.float32)
               for k, p in params.items()},
            v={k: _init_factored(p) for k, p in params.items()},
            s={k: _init_factored(p) for k, p in params.items()})

    def update(updates, state, params=None):
        out = {}
        for k, g in updates.items():
            g32 = g.float()
            m, v, s = state.m[k], state.v[k], state.s[k]
            _update_factored(v, g32.square() + eps1, b2)
            u = g32 * torch.rsqrt(_approx(v, g32.dim()) + eps1)
            rms = torch.sqrt(u.square().mean()) + 1e-30
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            m.mul_(b1).add_(u, alpha=1 - b1)
            _update_factored(s, (u - m).square() + eps2, b3)
            del u
            upd = m * torch.rsqrt(_approx(s, g32.dim()) + eps2)
            if weight_decay and params is not None:
                upd = upd + weight_decay * params[k].float()
            out[k] = (-learning_rate * upd).to(g.dtype)
        return out, CAMEState(state.count + 1, state.m, state.v, state.s)

    return GradientTransformation(init, update)
