"""The six samplers of the reference UI: flow-matching Euler (the V5.1
default), DDIM, Euler, Euler-Ancestral, PNDM (PLMS) and DPM-Solver++ (2M).

Parity: easyanimate_tpu/pipeline/schedulers.py (diffusers
FlowMatchEulerDiscreteScheduler with mu=1 dynamic shifting, as
pipeline_easyanimate.py:971-974 uses it; DDIMScheduler, Euler(Ancestral)
DiscreteScheduler, PNDMScheduler with skip_prk_steps, DPMSolverMultistep
with solver_order 2). Each schedule is host-side numpy; each step is a
tensor function whose arithmetic runs in float32 on the latents' device,
with its per-step coefficients computed on the host in float32 numpy (no
device sync). `schedule_arrays` lays a schedule out as JAX's per-step rows
and `SamplerLoop` carries a family's state (PNDM's history, DPM++'s last
x0) through the pipeline's denoise loop.
"""
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

_F32 = np.float32


# ---------------------------------------------------------------------------
# Flow matching (Euler)
# ---------------------------------------------------------------------------


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


def flow_match_step(sample: torch.Tensor, model_output: torch.Tensor,
                    sigma: float, sigma_next: float) -> torch.Tensor:
    """x_{t-1} = x_t + (sigma_next - sigma) * v, updated in float32."""
    out = sample.float() + float(_F32(sigma_next) - _F32(sigma)) \
        * model_output.float()
    return out.to(sample.dtype)


# ---------------------------------------------------------------------------
# DDPM / DDIM (IDDPM beta schedules)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DDIMConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.0001
    beta_end: float = 0.02
    beta_schedule: str = "scaled_linear"  # linear | scaled_linear | squaredcos_cap_v2
    prediction_type: str = "epsilon"       # epsilon | v_prediction | sample
    clip_sample: bool = False
    set_alpha_to_one: bool = True
    steps_offset: int = 0
    timestep_spacing: str = "leading"


def make_betas(cfg: DDIMConfig) -> np.ndarray:
    n = cfg.num_train_timesteps
    if cfg.beta_schedule == "linear":
        return np.linspace(cfg.beta_start, cfg.beta_end, n, dtype=np.float64)
    if cfg.beta_schedule == "scaled_linear":
        return np.linspace(cfg.beta_start ** 0.5, cfg.beta_end ** 0.5, n,
                           dtype=np.float64) ** 2
    if cfg.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        return np.array([min(1 - alpha_bar((i + 1) / n) / alpha_bar(i / n),
                             0.999) for i in range(n)], dtype=np.float64)
    raise ValueError(cfg.beta_schedule)


def _alphas(cfg: DDIMConfig) -> Tuple[np.ndarray, np.float32]:
    """(alphas_cumprod [T] float32, final_alpha)."""
    alphas_cumprod = np.cumprod(1.0 - make_betas(cfg)).astype(np.float32)
    final_alpha = _F32(1.0) if cfg.set_alpha_to_one else alphas_cumprod[0]
    return alphas_cumprod, final_alpha


def ddim_schedule(cfg: DDIMConfig, num_inference_steps: int):
    """Returns (timesteps [N] int32 descending, alphas_cumprod [T] float32,
    final_alpha)."""
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "leading":
        step_ratio = n // num_inference_steps
        timesteps = (np.arange(num_inference_steps) * step_ratio).round()[::-1]
        timesteps = timesteps + cfg.steps_offset
    elif cfg.timestep_spacing == "linspace":
        timesteps = np.linspace(0, n - 1, num_inference_steps).round()[::-1]
    elif cfg.timestep_spacing == "trailing":
        step_ratio = n / num_inference_steps
        timesteps = np.round(np.arange(n, 0, -step_ratio)).astype(np.int64) - 1
    else:
        raise ValueError(cfg.timestep_spacing)
    return (timesteps.astype(np.int32), *_alphas(cfg))


def _alpha_prev(alphas_cumprod, final_alpha, t_prev: int) -> np.float32:
    return _F32(alphas_cumprod[t_prev] if t_prev >= 0 else final_alpha)


def ddim_step(cfg: DDIMConfig, sample: torch.Tensor,
              model_output: torch.Tensor, t: int, t_prev: int,
              alphas_cumprod: np.ndarray, final_alpha) -> torch.Tensor:
    """Deterministic DDIM step (eta 0); t_prev < 0 steps to final_alpha."""
    x, eps = sample.float(), model_output.float()
    a_t = _F32(alphas_cumprod[t])
    a_prev = _alpha_prev(alphas_cumprod, final_alpha, t_prev)
    sa, sb = float(np.sqrt(a_t)), float(np.sqrt(_F32(1) - a_t))
    if cfg.prediction_type == "epsilon":
        x0 = (x - sb * eps) / sa
        eps_pred = eps
    elif cfg.prediction_type == "v_prediction":
        x0 = sa * x - sb * eps
        eps_pred = sa * eps + sb * x
    elif cfg.prediction_type == "sample":
        x0 = eps
        eps_pred = (x - sa * x0) / sb
    else:
        raise ValueError(cfg.prediction_type)
    if cfg.clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    prev = (float(np.sqrt(a_prev)) * x0
            + float(np.sqrt(_F32(1) - a_prev)) * eps_pred)
    return prev.to(sample.dtype)


def ddim_add_noise(clean: torch.Tensor, noise: torch.Tensor, t: int,
                   alphas_cumprod: np.ndarray) -> torch.Tensor:
    """sqrt(a_t) clean + sqrt(1 - a_t) noise at the integer timestep t."""
    a = _F32(alphas_cumprod[t])
    out = (float(np.sqrt(a)) * clean.float()
           + float(np.sqrt(_F32(1) - a)) * noise.float())
    return out.to(clean.dtype)


# ---------------------------------------------------------------------------
# Euler / Euler-Ancestral in sigma space
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EulerConfig(DDIMConfig):
    """Euler discrete sampler in sigma space: sigma = sqrt((1-a)/a); model
    inputs are pre-scaled by 1/sqrt(sigma^2+1) each step."""


@dataclasses.dataclass(frozen=True)
class EulerAncestralConfig(EulerConfig):
    """Euler-Ancestral: Euler step to sigma_down plus fresh noise sigma_up."""


def euler_schedule(cfg: EulerConfig, num_inference_steps: int):
    """Returns (timesteps [N] float32 descending, sigmas [N+1] float32,
    init_noise_sigma)."""
    n = cfg.num_train_timesteps
    if cfg.timestep_spacing == "linspace":
        timesteps = np.linspace(0, n - 1, num_inference_steps,
                                dtype=np.float64)[::-1]
    elif cfg.timestep_spacing == "leading":
        step_ratio = n // num_inference_steps
        timesteps = (np.arange(num_inference_steps) * step_ratio
                     ).round()[::-1].astype(np.float64)
        timesteps = timesteps + cfg.steps_offset
    elif cfg.timestep_spacing == "trailing":
        step_ratio = n / num_inference_steps
        timesteps = (np.round(np.arange(n, 0, -step_ratio)) - 1
                     ).astype(np.float64)
    else:
        raise ValueError(cfg.timestep_spacing)
    ac = np.cumprod(1.0 - make_betas(cfg))
    sigmas = np.interp(timesteps, np.arange(n), ((1.0 - ac) / ac) ** 0.5)
    # diffusers: linspace / trailing start at sigma_max, leading (the SD
    # default) at sqrt(sigma_max^2 + 1)
    if cfg.timestep_spacing in ("linspace", "trailing"):
        init_sigma = float(sigmas.max())
    else:
        init_sigma = float((sigmas.max() ** 2 + 1.0) ** 0.5)
    sigmas = np.concatenate([sigmas, [0.0]]).astype(np.float32)
    return timesteps.astype(np.float32), sigmas, init_sigma


def euler_scale_model_input(sample: torch.Tensor, sigma) -> torch.Tensor:
    """The model input sample / sqrt(sigma^2 + 1)."""
    s = _F32(sigma)
    out = sample.float() / float(np.sqrt(s * s + _F32(1)))
    return out.to(sample.dtype)


def _euler_x0(cfg, x: torch.Tensor, out: torch.Tensor, sigma: np.float32):
    if cfg.prediction_type == "epsilon":
        return x - float(sigma) * out
    if cfg.prediction_type == "v_prediction":
        s2 = sigma * sigma + _F32(1)
        return out * float(-sigma / np.sqrt(s2)) + x / float(s2)
    if cfg.prediction_type == "sample":
        return out
    raise ValueError(cfg.prediction_type)


def euler_step(cfg: EulerConfig, sample: torch.Tensor,
               model_output: torch.Tensor, sigma, sigma_next) -> torch.Tensor:
    x, out = sample.float(), model_output.float()
    sigma, sigma_next = _F32(sigma), _F32(sigma_next)
    derivative = (x - _euler_x0(cfg, x, out, sigma)) / float(sigma)
    prev = x + derivative * float(sigma_next - sigma)
    return prev.to(sample.dtype)


def euler_ancestral_step(cfg: EulerAncestralConfig, sample: torch.Tensor,
                         model_output: torch.Tensor, sigma, sigma_next,
                         noise: torch.Tensor) -> torch.Tensor:
    """Euler to sigma_down, then noise * sigma_up (`noise` unit normal)."""
    x, out = sample.float(), model_output.float()
    sigma, sigma_next = _F32(sigma), _F32(sigma_next)
    x0 = _euler_x0(cfg, x, out, sigma)
    var = sigma_next ** 2 * (sigma ** 2 - sigma_next ** 2) / sigma ** 2
    sigma_up = np.sqrt(np.maximum(var, _F32(0)))
    sigma_down = np.sqrt(np.maximum(sigma_next ** 2 - sigma_up ** 2, _F32(0)))
    derivative = (x - x0) / float(sigma)
    prev = x + derivative * float(sigma_down - sigma)
    prev = prev + noise.float() * float(sigma_up)
    return prev.to(sample.dtype)


# ---------------------------------------------------------------------------
# PNDM (PLMS with lower-order warm-up; diffusers PNDMScheduler with
# skip_prk_steps=True). The counter == 1 quirk -- the second eval re-steps
# from the FIRST step's input with the averaged epsilon -- is kept; its
# data dependence is laid out on the host as per-eval rows.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PNDMConfig(DDIMConfig):
    pass


def pndm_schedule(cfg: PNDMConfig, num_inference_steps: int,
                  t_start: int = 0):
    """Per-EVAL rows [t_eval, t_step, t_prev, order_code, append, use_cur]
    (num_inference_steps + 1 rows: the 2nd timestep is evaluated twice),
    float32 numpy, plus (alphas_cumprod, final_alpha).

    order_code: 0 = 1st order, 1 = avg(new, prev) at the duplicated step,
    2/3/4 = Adams-Bashforth of that order. t_start > 0 (V2V strength) drops
    the largest t_start timesteps and replays the warm-up on the truncated
    schedule (a fresh counter)."""
    n = cfg.num_train_timesteps
    # the counter-1 shift always uses the leading ratio (diffusers
    # step_plms takes n // num_inference_steps whatever the spacing)
    step_ratio = n // num_inference_steps
    if cfg.timestep_spacing == "leading":
        ts = ((np.arange(num_inference_steps) * step_ratio).round()
              + cfg.steps_offset)
    elif cfg.timestep_spacing == "linspace":
        ts = np.linspace(0, n - 1, num_inference_steps).round()
    elif cfg.timestep_spacing == "trailing":
        ts = np.round(np.arange(n, 0, -n / num_inference_steps))[::-1] - 1
    else:
        raise ValueError(cfg.timestep_spacing)
    if t_start:
        ts = ts[: len(ts) - t_start]
    plms = (np.concatenate([ts[:-1], ts[-2:-1], ts[-1:]])[::-1]
            if len(ts) > 1 else ts[::-1])
    rows = []
    for counter, t in enumerate(plms):
        if counter == 1 and len(ts) > 1:
            rows.append([t, t + step_ratio, t, 1, 0, 1])
        else:
            rows.append([t, t, t - step_ratio,
                         0 if counter == 0 else min(counter, 4), 1, 0])
    return (np.asarray(rows, np.float32), *_alphas(cfg))


def pndm_prev_sample(cfg: PNDMConfig, sample: torch.Tensor,
                     model_output: torch.Tensor, t: int, t_prev: int,
                     alphas_cumprod: np.ndarray, final_alpha) -> torch.Tensor:
    """PNDM paper eq. 11 transfer (diffusers PNDMScheduler._get_prev_sample)
    of the COMBINED raw model output; v_prediction converts to epsilon here,
    at the (possibly counter-1-shifted) step timestep with the transfer
    sample, where diffusers does it."""
    x, eps = sample.float(), model_output.float()
    a_t = _F32(alphas_cumprod[t])
    if cfg.prediction_type == "v_prediction":
        eps = (float(np.sqrt(a_t)) * eps
               + float(np.sqrt(_F32(1) - a_t)) * x)
    a_prev = _alpha_prev(alphas_cumprod, final_alpha, t_prev)
    b_t, b_prev = _F32(1) - a_t, _F32(1) - a_prev
    sample_coeff = np.sqrt(a_prev / a_t)
    denom = a_t * np.sqrt(b_prev) + np.sqrt(a_t * b_t * a_prev)
    prev = float(sample_coeff) * x - float(a_prev - a_t) * eps / float(denom)
    return prev.to(sample.dtype)


def pndm_combine(order_code: int, new_eps: torch.Tensor, ets) -> torch.Tensor:
    """The new epsilon blended with the history per the PLMS order; `ets`
    holds 4 tensors, newest first, BEFORE this eval's append."""
    e = new_eps.float()
    if order_code == 0:
        return e
    if order_code == 1:
        return (e + ets[0]) / 2.0
    if order_code == 2:
        return (3.0 * e - ets[0]) / 2.0
    if order_code == 3:
        return (23.0 * e - 16.0 * ets[0] + 5.0 * ets[1]) / 12.0
    return (55.0 * e - 59.0 * ets[0] + 37.0 * ets[1] - 9.0 * ets[2]) / 24.0


# ---------------------------------------------------------------------------
# DPM-Solver++ (2M), lower order at the first and the final step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DPMSolverConfig(DDIMConfig):
    solver_order: int = 2


def dpm_lambda(alphas_cumprod: np.ndarray, t: int) -> np.float32:
    """log(alpha_t) - log(sigma_t), the half log-SNR."""
    a = _F32(alphas_cumprod[t])
    return np.log(np.sqrt(a)) - np.log(np.sqrt(_F32(1) - a))


def dpm_solver_step(cfg: DPMSolverConfig, sample: torch.Tensor,
                    model_output: torch.Tensor, t: int, t_prev: int,
                    prev_x0: torch.Tensor, step_index: int,
                    alphas_cumprod: np.ndarray):
    """One DPM++ (2M) step carrying the previous x0 prediction; the first
    step (and a step to t_prev < 0) is first order. Returns (new_sample,
    x0_pred float32)."""
    x, out = sample.float(), model_output.float()
    ac = alphas_cumprod
    a_t, s_t = np.sqrt(_F32(ac[t])), np.sqrt(_F32(1) - _F32(ac[t]))
    if cfg.prediction_type == "epsilon":
        x0 = (x - float(s_t) * out) / float(a_t)
    elif cfg.prediction_type == "v_prediction":
        x0 = float(a_t) * x - float(s_t) * out
    else:
        x0 = out
    if cfg.clip_sample:
        x0 = x0.clamp(-1.0, 1.0)
    if t_prev >= 0:
        a_p, s_p = np.sqrt(_F32(ac[t_prev])), np.sqrt(_F32(1) - _F32(ac[t_prev]))
    else:
        a_p, s_p = _F32(1.0), _F32(1e-3)
    h = (np.log(a_p) - np.log(s_p)) - (np.log(a_t) - np.log(s_t))
    coef = float(a_p * (np.exp(-h) - _F32(1)))
    new = float(s_p / s_t) * x - coef * x0
    if step_index > 0 and t_prev >= 0:
        # second order: D1 from the previous x0 (r0 ~ 1 on a uniform grid)
        new = new - 0.5 * coef * (x0 - prev_x0)
    return new.to(sample.dtype), x0


# ---------------------------------------------------------------------------
# Registry, runtime switch and the loop's view of a schedule
# ---------------------------------------------------------------------------

# the reference UI's sampler names (ui.py:44-55)
SAMPLER_REGISTRY = {
    "flow": FlowMatchEulerConfig,
    "euler": EulerConfig,
    "euler a": EulerAncestralConfig,
    "dpm++": DPMSolverConfig,
    "pndm": PNDMConfig,
    "ddim": DDIMConfig,
}
_SAMPLER_ALIASES = {"euler ancestral": "euler a", "dpm solver": "dpm++",
                    "dpm": "dpm++", "flow match": "flow"}


def init_noise_sigma(sched, num_inference_steps: int) -> float:
    """Initial latent scale (diffusers scheduler.init_noise_sigma): the
    sigma-space Euler samplers start from sigma_max-scaled noise; every
    other family at 1.0."""
    if isinstance(sched, EulerConfig):
        return euler_schedule(sched, num_inference_steps)[2]
    return 1.0


def make_scheduler(name: str, base=None, **overrides):
    """Runtime sampler switch (reference ui.py:472
    `all_cheduler_dict[sampler_dropdown].from_config(scheduler.config)`):
    the named sampler with every field it shares with `base`, across
    families too (a FlowMatch base's num_train_timesteps reaches DDIM);
    re-selecting the base's own class keeps all of its fields."""
    key = name.strip().lower().replace("_", " ").replace("-", " ")
    key = _SAMPLER_ALIASES.get(key, key)
    if key not in SAMPLER_REGISTRY:
        raise ValueError(f"unknown sampler {name!r}; one of "
                         f"{sorted(SAMPLER_REGISTRY)}")
    cls = SAMPLER_REGISTRY[key]
    if type(base) is cls or (cls is FlowMatchEulerConfig
                             and isinstance(base, FlowMatchEulerConfig)):
        return dataclasses.replace(base, **overrides)
    fields = {}
    if base is not None and dataclasses.is_dataclass(base):
        names = {f.name for f in dataclasses.fields(cls)}
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(type(base)) if f.name in names}
    fields.update(overrides)
    return cls(**fields)


def schedule_arrays(sched, steps: int, t_start: int = 0):
    """The per-step rows of the denoise loop from step t_start on (JAX
    t2v.py:222-250; t_start implements `strength`, the reference's
    get_timesteps), float32 numpy, with (alphas_cumprod, final_alpha) for
    the alpha-space families (None otherwise). Columns: flow / Euler
    (t, sigma, sigma_next); DDIM / DPM++ (t, t_prev, 0); PNDM the 6 columns
    of pndm_schedule, whose truncation replays the warm-up."""
    if isinstance(sched, FlowMatchEulerConfig):
        timesteps, sigmas = flow_match_schedule(sched, steps, mu=1.0)
        extras = None
    elif isinstance(sched, EulerConfig):  # and EulerAncestralConfig
        timesteps, sigmas, _ = euler_schedule(sched, steps)
        extras = None
    elif isinstance(sched, PNDMConfig):
        rows, ac, final_alpha = pndm_schedule(sched, steps, t_start)
        return rows, (ac, final_alpha)
    elif isinstance(sched, DDIMConfig):  # and DPMSolverConfig
        t_arr, ac, final_alpha = ddim_schedule(sched, steps)
        t_prev = np.concatenate([t_arr[1:], [-1]])
        per_step = np.stack([t_arr, t_prev, np.zeros_like(t_arr)],
                            axis=1).astype(np.float32)
        return per_step[t_start:], (ac, final_alpha)
    else:
        raise TypeError(f"unknown scheduler {type(sched)}")
    per_step = np.stack([timesteps, sigmas[:-1], sigmas[1:]], axis=1)
    return per_step[t_start:], extras


class SamplerLoop:
    """One run of a sampler over the rows of schedule_arrays: the model's
    timestep and input at each row, and the step that carries the family's
    state (PNDM's 4-deep epsilon history and first sample, DPM++'s last
    x0). Euler-A draws its per-step noise from `generator` (JAX folds the
    step into its key; those bits cannot be matched)."""

    def __init__(self, sched, steps: int, t_start: int = 0,
                 generator: Optional[torch.Generator] = None):
        self.sched, self.generator = sched, generator
        self.rows, extras = schedule_arrays(sched, steps, t_start)
        self.alphas_cumprod, self.final_alpha = extras or (None, None)
        self.ets = self.cur = self.prev_x0 = None

    def __len__(self) -> int:
        return len(self.rows)

    def timestep(self, i: int) -> float:
        return float(self.rows[i, 0])

    def model_input(self, i: int, latents: torch.Tensor) -> torch.Tensor:
        """Euler-family latents live in sigma space: the model sees them
        scaled by 1/sqrt(sigma^2 + 1) (diffusers scale_model_input)."""
        if isinstance(self.sched, EulerConfig):
            return euler_scale_model_input(latents, self.rows[i, 1])
        return latents

    def step(self, i: int, latents: torch.Tensor,
             pred: torch.Tensor) -> torch.Tensor:
        s, row = self.sched, self.rows[i]
        ac, fa = self.alphas_cumprod, self.final_alpha
        if isinstance(s, FlowMatchEulerConfig):
            return flow_match_step(latents, pred, row[1], row[2])
        if isinstance(s, EulerAncestralConfig):
            noise = torch.randn(latents.shape, generator=self.generator,
                                device=latents.device, dtype=torch.float32)
            return euler_ancestral_step(s, latents, pred, row[1], row[2],
                                        noise)
        if isinstance(s, EulerConfig):
            return euler_step(s, latents, pred, row[1], row[2])
        if isinstance(s, PNDMConfig):
            # ets keeps RAW model outputs (v or epsilon); pndm_prev_sample
            # converts the combined output (diffusers ordering)
            eps, lat32 = pred.float(), latents.float()
            if self.ets is None:
                self.ets = [torch.zeros_like(lat32)] * 4
                self.cur = lat32
            out = pndm_combine(int(row[3]), eps, self.ets)
            if row[4] > 0.5:
                self.ets = [eps] + self.ets[:3]
            used = self.cur if row[5] > 0.5 else lat32
            return pndm_prev_sample(s, used, out, int(row[1]), int(row[2]),
                                    ac, fa).to(latents.dtype)
        if isinstance(s, DPMSolverConfig):
            if self.prev_x0 is None:
                self.prev_x0 = torch.zeros_like(latents, dtype=torch.float32)
            latents, self.prev_x0 = dpm_solver_step(
                s, latents, pred, int(row[0]), int(row[1]), self.prev_x0, i,
                ac)
            return latents
        return ddim_step(s, latents, pred, int(row[0]), int(row[1]), ac, fa)


def rescale_noise_cfg(noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor,
                      guidance_rescale: float) -> torch.Tensor:
    """CFG rescale, arXiv:2305.08891 section 3.4
    (pipeline_easyanimate.py:101-112); population std over non-batch dims."""
    dims = tuple(range(1, noise_cfg.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg
