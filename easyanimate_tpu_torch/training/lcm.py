"""LCM-LoRA distillation (latent consistency models) on one device.

Parity: easyanimate_tpu/training/lcm.py (reference
scripts/train_lcm_lora.py: DDIMSolver over a skipped timestep grid :419,
boundary scalings c_skip / c_out :368-376, the frozen teacher's
CFG-combined x0 and one ODE step to the target timestep :2005-2050, huber
consistency loss against the target network, an EMA of the student LoRA).

Three roles share one set of base weights, and no LoRA is ever merged into
them (the 12B is never copied):
  - student = base + the trained LoRA (training/lora.py::attach_lora);
  - teacher = base alone, evaluated on `text` and on `negative_text`
    (zeros by default, as JAX's lcm.py:95: not an encoded empty prompt);
  - target = base + the EMA LoRA, at t_prev.
The teacher and target run first, each under no_grad, and the student's
forward and backward run inside the student's own attach_lora context:
the remat backward recomputes each block with the hooks that are live, so
the student's backward must never see a second LoRA attached.

The model's first C output channels are read as eps on the DDPM grid, as
JAX does (lcm.py:84-89), also for the flow-trained V5.1. Random draws come
from a torch.Generator, or are handed in (`draws`) so that a test can give
both packages the same numbers.
"""
import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..pipeline.schedulers import DDIMConfig, make_betas
from . import optim
from .lora import LoRAConfig, attach_lora, flatten_lora, lora_init
from .trainer import TrainConfig, TrainState, make_optimizer


@dataclasses.dataclass(frozen=True)
class LCMConfig:
    num_ddim_timesteps: int = 50
    w_min: float = 3.0
    w_max: float = 15.0
    timestep_scaling: float = 10.0
    sigma_data: float = 0.5
    huber_c: float = 0.001
    ema_decay: float = 0.95


def boundary_scalings(t: torch.Tensor, cfg: LCMConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """c_skip, c_out (float32) so the consistency function is the identity
    at t = 0 (train_lcm_lora.py:368-376)."""
    ts = t.float() * cfg.timestep_scaling
    c_skip = cfg.sigma_data ** 2 / (ts ** 2 + cfg.sigma_data ** 2)
    c_out = ts / torch.sqrt(ts ** 2 + cfg.sigma_data ** 2)
    return c_skip, c_out


def _per_sample(v: torch.Tensor, ndim: int) -> torch.Tensor:
    return v.reshape(-1, *([1] * (ndim - 1)))


class DDIMSolver:
    """x0 / eps coefficients on the skipped DDIM grid: timesteps and
    prev_timesteps (int64 numpy), alphas_cumprod and ac_prev (float32 on
    `device`)."""

    def __init__(self, sched: DDIMConfig, cfg: LCMConfig, device=None):
        alphas_cumprod = np.cumprod(1 - make_betas(sched))
        step = sched.num_train_timesteps // cfg.num_ddim_timesteps
        self.timesteps = (np.arange(1, cfg.num_ddim_timesteps + 1) * step
                          ).round().astype(np.int64) - 1
        self.prev_timesteps = self.timesteps - step
        ac_prev = np.where(self.prev_timesteps >= 0,
                           alphas_cumprod[np.clip(self.prev_timesteps, 0, None)],
                           1.0)
        self.alphas_cumprod = torch.tensor(alphas_cumprod, dtype=torch.float32,
                                           device=device)
        self.ac_prev = torch.tensor(ac_prev, dtype=torch.float32,
                                    device=device)

    def step(self, x0: torch.Tensor, eps: torch.Tensor, idx: torch.Tensor):
        """x_{t_prev} = sqrt(ac_prev) x0 + sqrt(1 - ac_prev) eps."""
        a = _per_sample(self.ac_prev[idx], x0.ndim)
        return torch.sqrt(a) * x0 + torch.sqrt(1 - a) * eps


class LCMDraws(NamedTuple):
    """The random inputs of one LCM step."""
    idx: torch.Tensor    # [B] int64, index into the DDIM grid
    noise: torch.Tensor  # latents' shape, float32
    w: torch.Tensor      # [B] float32, guidance in [w_min, w_max)


def draw_lcm_inputs(generator: Optional[torch.Generator],
                    latents: torch.Tensor, cfg: LCMConfig) -> LCMDraws:
    """Grid index, then N(0, 1) noise, then U[w_min, w_max) guidance."""
    b, dev = latents.shape[0], latents.device
    idx = torch.randint(0, cfg.num_ddim_timesteps, (b,), generator=generator,
                        device=dev)
    noise = torch.randn(latents.shape, generator=generator, device=dev)
    u = torch.rand(b, generator=generator, device=dev)
    return LCMDraws(idx, noise, cfg.w_min + (cfg.w_max - cfg.w_min) * u)


def make_lcm_train_step(model: torch.nn.Module, sched: DDIMConfig,
                        lcm_cfg: LCMConfig, lora_cfg: LoRAConfig,
                        train_cfg: TrainConfig) -> Tuple[Callable, Callable]:
    """Returns (init_fn, step_fn). Only the student LoRA trains; the base
    parameters are frozen and never change; the target network is an EMA
    copy of the LoRA factors (TrainState.ema_params).

    init_fn(generator=None, lora=None) -> TrainState. step(state, batch,
    generator=None, draws=None) -> (state, {"loss", "grad_norm"}); batch:
    latents (B, C, T, H, W), text, optional negative_text and rope."""
    model.requires_grad_(False)
    tx = make_optimizer(train_cfg)
    device = next(model.parameters()).device
    solver = DDIMSolver(sched, lcm_cfg, device)
    ac = solver.alphas_cumprod
    timesteps = torch.from_numpy(solver.timesteps).to(device)
    prev_timesteps = torch.from_numpy(solver.prev_timesteps).clamp(min=0
                                                                   ).to(device)

    def init_fn(generator=None, lora=None) -> TrainState:
        if lora is None:
            lora = lora_init(model, lora_cfg, generator)
        for t in flatten_lora(lora).values():
            t.requires_grad_(True)
        ema = {p: {k: t.detach().clone() for k, t in f.items()}
               for p, f in lora.items()}
        return TrainState(step=0, params=lora,
                          opt_state=tx.init(flatten_lora(lora)),
                          ema_params=ema)

    def pred_x0_eps(xt, t, txt, rope):
        out = model(xt, t.float(), txt, rope)
        eps = out[:, :xt.shape[1]].float()
        a = _per_sample(ac[t], xt.ndim)
        x0 = (xt.float() - torch.sqrt(1 - a) * eps) / torch.sqrt(a)
        return x0, eps

    def step(state: TrainState, batch, generator=None, draws=None):
        lat_dtype = batch["latents"].dtype
        latents = batch["latents"].float()
        txt, rope = batch["text"], batch.get("rope")
        neg = batch.get("negative_text")
        if neg is None:
            neg = torch.zeros_like(txt)
        if draws is None:
            draws = draw_lcm_inputs(generator, latents, lcm_cfg)
        nd = latents.ndim
        t, t_prev = timesteps[draws.idx], prev_timesteps[draws.idx]
        a = _per_sample(ac[t], nd)
        xt = (torch.sqrt(a) * latents
              + torch.sqrt(1 - a) * draws.noise.float()).to(lat_dtype)
        wb = _per_sample(draws.w.float(), nd)

        with torch.no_grad():
            # teacher: base weights, CFG x0 / eps, one ODE step to t_prev
            x0_c, eps_c = pred_x0_eps(xt, t, txt, rope)
            x0_u, eps_u = pred_x0_eps(xt, t, neg, rope)
            x_prev = solver.step(x0_c + wb * (x0_c - x0_u),
                                 eps_c + wb * (eps_c - eps_u), draws.idx)
            del x0_c, eps_c, x0_u, eps_u
            # target network: base + the EMA LoRA at t_prev
            with attach_lora(model, state.ema_params, lora_cfg):
                x0_tn, _ = pred_x0_eps(x_prev.to(lat_dtype), t_prev, txt,
                                       rope)
            cs_p, co_p = boundary_scalings(t_prev, lcm_cfg)
            target = (_per_sample(cs_p, nd) * x_prev
                      + _per_sample(co_p, nd) * x0_tn)
            del x0_tn, x_prev

        flat = flatten_lora(state.params)
        for p in flat.values():
            p.grad = None
        c_skip, c_out = boundary_scalings(t, lcm_cfg)
        with attach_lora(model, state.params, lora_cfg):
            x0_s, _ = pred_x0_eps(xt, t, txt, rope)
            model_pred = (_per_sample(c_skip, nd) * xt.float()
                          + _per_sample(c_out, nd) * x0_s)
            diff = model_pred - target
            c = lcm_cfg.huber_c
            loss = torch.mean(torch.sqrt(diff.square() + c ** 2) - c)
            loss.backward()
        # the last block's text stream never reaches the loss: zero, as JAX
        grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                 for k, p in flat.items()}
        metrics = {"loss": loss.detach(), "grad_norm": optim.global_norm(grads)}
        updates, opt_state = tx.update(grads, state.opt_state, flat)
        optim.apply_updates(flat, updates)
        d = lcm_cfg.ema_decay
        ema = flatten_lora(state.ema_params)
        with torch.no_grad():
            for k, p in flat.items():
                ema[k].copy_(d * ema[k] + (1 - d) * p)
                p.grad = None
        return dataclasses.replace(state, step=state.step + 1,
                                   opt_state=opt_state), metrics

    return init_fn, step
