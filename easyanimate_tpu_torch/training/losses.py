"""Training losses and timestep samplers.

Parity: easyanimate_tpu/training/losses.py (reference scripts/train.py):
  flow matching: density-weighted sigma sampling (:2022-2030), sigma-interp
  noising x_t = (1 - s) x0 + s eps (:2032-2038), target = eps - x0
  custom_mse_loss outlier mask |diff| <= 50 (:2059-2076)
  DiscreteSampling rank-banded timesteps (utils/discrete_sampler.py:11-40),
  banded by batch index.
Random draws come from a torch.Generator where JAX takes a key; the
formulas after the draw are the JAX package's, in float32.
"""
import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchLossConfig:
    num_train_timesteps: int = 1000
    shift: float = 3.0
    weighting_scheme: str = "logit_normal"  # 'logit_normal'|'mode'|'uniform'
    logit_mean: float = 0.0
    logit_std: float = 1.0
    mode_scale: float = 1.29
    uniform_bands: int = 0   # >0: DiscreteSampling-style banding over batch
    loss_outlier_threshold: float = 50.0


def draw_flow_u(generator: Optional[torch.Generator], batch: int,
                cfg: FlowMatchLossConfig,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """The random draw of sample_flow_sigmas: N(0, 1) for 'logit_normal',
    U[0, 1) otherwise, float32 [batch]."""
    if cfg.weighting_scheme == "logit_normal":
        return torch.randn(batch, generator=generator, device=device)
    return torch.rand(batch, generator=generator, device=device)


def flow_sigmas_from_u(draw: torch.Tensor, cfg: FlowMatchLossConfig
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sigmas [B], timesteps [B]) from draw_flow_u's draw: density
    weighting, banding, discretisation to the training timesteps, shift."""
    u = draw.float()
    if cfg.weighting_scheme == "logit_normal":
        u = torch.sigmoid(u * cfg.logit_std + cfg.logit_mean)
    elif cfg.weighting_scheme == "mode":
        u = 1 - u - cfg.mode_scale * (torch.cos(math.pi * u / 2) ** 2 - 1 + u)
    if cfg.uniform_bands > 1:
        band = torch.arange(u.shape[0], device=u.device) % cfg.uniform_bands
        u = (band + u) / cfg.uniform_bands
    n = cfg.num_train_timesteps
    idx = (u * n).to(torch.int32).clamp(0, n - 1)
    base = (idx.float() + 1.0) / n
    sigmas = cfg.shift * base / (1 + (cfg.shift - 1) * base)
    return sigmas, sigmas * n


def sample_flow_sigmas(generator: Optional[torch.Generator], batch: int,
                       cfg: FlowMatchLossConfig,
                       device: Optional[torch.device] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (sigmas [B], timesteps [B]) with density weighting + shift."""
    return flow_sigmas_from_u(draw_flow_u(generator, batch, cfg, device), cfg)


def flow_noise_and_target(latents: torch.Tensor, noise: torch.Tensor,
                          sigmas: torch.Tensor):
    """x_t = (1-s) x0 + s eps; target = eps - x0 (train.py:2032-2038)."""
    s = sigmas.float().reshape(sigmas.shape[0], *([1] * (latents.dim() - 1)))
    x0 = latents.float()
    eps = noise.float()
    noisy = (1.0 - s) * x0 + s * eps
    return noisy.to(latents.dtype), eps - x0


def masked_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    threshold: float = 50.0,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MSE over elements where |pred - target| <= threshold
    (train.py custom_mse_loss)."""
    diff = pred.float() - target.float()
    mask = (diff.abs() <= threshold).float()
    sq = diff.square() * mask
    if weights is not None:
        sq = sq * weights.float().reshape(weights.shape[0],
                                          *([1] * (diff.dim() - 1)))
    return sq.sum() / mask.sum().clamp_min(1.0)


def ddpm_sample_timesteps(generator: Optional[torch.Generator], batch: int,
                          num_train: int = 1000, uniform_bands: int = 0,
                          device: Optional[torch.device] = None
                          ) -> torch.Tensor:
    """Integer timesteps [B]: uniform over [0, num_train), or one band of
    num_train // uniform_bands per batch index."""
    if uniform_bands > 1:
        band = torch.arange(batch, device=device) % uniform_bands
        width = num_train // uniform_bands
        off = torch.randint(0, width, (batch,), generator=generator,
                            device=device)
        return band * width + off
    return torch.randint(0, num_train, (batch,), generator=generator,
                         device=device)


def motion_sub_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """MSE between temporal deltas of pred and target over the frame axis
    (latents are (B, C, T, H, W); train.py:2078-2081)."""
    p, t = pred.float(), target.float()
    return ((p[:, :, 1:] - p[:, :, :-1]) - (t[:, :, 1:] - t[:, :, :-1])
            ).square().mean()


def with_motion_sub_loss(loss, pred, target, ratio: float):
    """loss*(1-r) + motion_sub_mse*r, active only when T > 2
    (train.py:2078-2082)."""
    if pred.dim() < 5 or pred.shape[2] <= 2:
        return loss
    return loss * (1.0 - ratio) + motion_sub_mse(pred, target) * ratio
