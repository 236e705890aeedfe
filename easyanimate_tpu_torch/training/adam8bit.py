"""8-bit-state AdamW as a gradient transformation over {name: tensor}
dicts (reference `--use_8bit_adam`, train.py:1186-1194, bitsandbytes
AdamW8bit).

Parity: easyanimate_tpu/training/adam8bit.py. Both Adam moments are
stored blockwise-quantized to int8 with one float32 scale per block of
`block_size` elements (linear absmax on m, absmax of sqrt(v) on v). State
per parameter: int8 m, int8 sqrt(v) and the scales, ~2 bytes a parameter
against 8 for float32 Adam; it stays int8 on the parameter's device. Each
update dequantizes one parameter's blocks at a time, so the float32
moments exist for one tensor only.
"""
from typing import NamedTuple

import numpy as np
import torch

from .optim import GradientTransformation, Params


class Adam8bitState(NamedTuple):
    count: int
    m_q: Params       # int8 blocks (n_blocks, block_size)
    m_scale: Params   # float32 per-block scales (n_blocks,)
    v_q: Params       # int8 blocks of sqrt(v)
    v_scale: Params


def _blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def _quantize_(xb: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> None:
    """q, scale <- round(xb / s) as int8, s = max |xb| per block / 127."""
    s = xb.abs().amax(dim=-1, keepdim=True) / 127.0
    q.copy_(torch.round(xb / s.clamp_min(1e-30)).to(torch.int8))
    scale.copy_(s[:, 0])


def scale_by_adam8bit(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                      block_size: int = 2048) -> GradientTransformation:
    def init(params):
        def zeros(p, dtype, *tail):
            n = max(1, -(-p.numel() // block_size))
            return torch.zeros((n, *tail), dtype=dtype, device=p.device)

        return Adam8bitState(
            count=0,
            m_q={k: zeros(p, torch.int8, block_size) for k, p in params.items()},
            m_scale={k: zeros(p, torch.float32) for k, p in params.items()},
            v_q={k: zeros(p, torch.int8, block_size) for k, p in params.items()},
            v_scale={k: zeros(p, torch.float32) for k, p in params.items()})

    def update(updates, state, params=None):
        count = state.count + 1
        # float32, as JAX computes them from its int32 counter
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        out = {}
        for k, g in updates.items():
            mq, ms = state.m_q[k], state.m_scale[k]
            vq, vs = state.v_q[k], state.v_scale[k]
            gb = _blocked(g, block_size)
            m = mq.float() * ms[:, None]
            v = (vq.float() * vs[:, None]).square()
            m = b1 * m + (1.0 - b1) * gb
            v = b2 * v + (1.0 - b2) * gb * gb
            ub = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            out[k] = ub.reshape(-1)[:g.numel()].reshape(g.shape).to(g.dtype)
            _quantize_(m, mq, ms)
            _quantize_(torch.sqrt(v), vq, vs)
        return out, Adam8bitState(count, state.m_q, state.m_scale,
                                  state.v_q, state.v_scale)

    return GradientTransformation(init, update)
