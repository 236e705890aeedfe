"""Flow-matching Euler sampler (the V5.1 default).

Parity: easyanimate_tpu/pipeline/schedulers.py (diffusers
FlowMatchEulerDiscreteScheduler as pipeline_easyanimate.py:971-974 uses it,
mu=1 dynamic shifting). The schedule is host-side numpy; the step is a
tensor function. The DDIM / Euler / DPM / PNDM families are not ported:
`make_scheduler` knows their names and raises for them.
"""
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FlowMatchEulerConfig:
    num_train_timesteps: int = 1000
    shift: float = 3.0
    use_dynamic_shifting: bool = True


def flow_match_schedule(cfg: FlowMatchEulerConfig, num_inference_steps: int,
                        mu: Optional[float] = 1.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (timesteps [N], sigmas [N+1]) as float32 numpy."""
    n = cfg.num_train_timesteps
    # base sigmas t/N for t in linspace(N, 1)
    sigmas = np.linspace(1.0 * n, (1.0 / n) * n, num_inference_steps,
                         dtype=np.float64) / n
    if cfg.use_dynamic_shifting:
        if mu is None:
            raise ValueError("dynamic shifting needs mu")
        sigmas = math.exp(mu) / (math.exp(mu) + (1.0 / sigmas - 1.0))
    else:
        sigmas = cfg.shift * sigmas / (1 + (cfg.shift - 1) * sigmas)
    timesteps = (sigmas * n).astype(np.float32)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return timesteps, sigmas


def flow_match_per_step(cfg: FlowMatchEulerConfig, num_inference_steps: int,
                        t_start: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """The schedule from step t_start on (JAX schedule_arrays'
    per_step[t_start:], the reference get_timesteps for `strength`):
    (timesteps [N - t_start], sigmas [N - t_start + 1])."""
    timesteps, sigmas = flow_match_schedule(cfg, num_inference_steps, mu=1.0)
    return timesteps[t_start:], sigmas[t_start:]


def flow_match_step(sample: torch.Tensor, model_output: torch.Tensor,
                    sigma: float, sigma_next: float) -> torch.Tensor:
    """x_{t-1} = x_t + (sigma_next - sigma) * v, updated in float32."""
    out = sample.float() + (sigma_next - sigma) * model_output.float()
    return out.to(sample.dtype)


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float) -> torch.Tensor:
    """CFG rescale, arXiv:2305.08891 section 3.4
    (pipeline_easyanimate.py:101-112); population std over non-batch dims."""
    dims = tuple(range(1, noise_cfg.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg


def init_noise_sigma(sched, num_inference_steps: int) -> float:
    """Initial latent scale (diffusers scheduler.init_noise_sigma): 1.0 for
    flow matching."""
    if not isinstance(sched, FlowMatchEulerConfig):
        raise NotImplementedError(f"sampler {type(sched).__name__} not ported")
    return 1.0


# the reference UI's sampler names (ui.py:44-55); only "flow" is ported
SAMPLER_NAMES = ("flow", "euler", "euler a", "dpm++", "pndm", "ddim")
_SAMPLER_ALIASES = {"euler ancestral": "euler a", "dpm solver": "dpm++",
                    "dpm": "dpm++", "flow match": "flow"}


def make_scheduler(name: str, base=None, **overrides):
    """Runtime sampler switch (JAX schedulers.py:447, reference ui.py:472):
    the named sampler with the base scheduler's fields. "Flow" (and its
    aliases) gives FlowMatchEulerConfig; the other known names raise
    NotImplementedError, an unknown one ValueError."""
    key = name.strip().lower().replace("_", " ").replace("-", " ")
    key = _SAMPLER_ALIASES.get(key, key)
    if key not in SAMPLER_NAMES:
        raise ValueError(f"unknown sampler {name!r}; one of "
                         f"{sorted(SAMPLER_NAMES)}")
    if key != "flow":
        raise NotImplementedError(f"sampler {name!r} is not ported (ROADMAP "
                                  "queue 1 item 6)")
    if isinstance(base, FlowMatchEulerConfig):
        return dataclasses.replace(base, **overrides)
    return FlowMatchEulerConfig(**overrides)
