"""IDDPM gaussian diffusion math: q / p distributions, the learned-range
VB loss, timestep respacing.

Parity: easyanimate_tpu/utils/diffusion.py (reference
easyanimate/utils/gaussian_diffusion.py, training_losses :715-823,
_vb_terms_bpd :682; respace.py). This is the 'sigma' training mode of
scripts/train.py (:938-942): the model predicts [eps, v] over 2C channels
and the VB term supervises the learned variance interpolation; 'ddpm' is
the eps MSE alone. The tables are computed in float64 and used in float32,
as JAX does. Random draws come from a torch.Generator, or are handed in.
"""
import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..pipeline.schedulers import DDIMConfig, make_betas


def _extract(arr: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """arr[t] broadcast to an ndim-tensor shape (B, 1, 1, ...)."""
    return arr.to(t.device)[t.long()].reshape(t.shape[0], *([1] * (ndim - 1)))


@dataclasses.dataclass(frozen=True)
class GaussianDiffusion:
    betas: Tuple[float, ...]

    @classmethod
    def from_config(cls, cfg: DDIMConfig) -> "GaussianDiffusion":
        return cls(tuple(make_betas(cfg)))

    @classmethod
    def spaced(cls, cfg: DDIMConfig, use_timesteps: Sequence[int]
               ) -> Tuple["GaussianDiffusion", np.ndarray]:
        """SpacedDiffusion: betas rebuilt over a timestep subset, and the
        original-timestep map (respace.py:12-131)."""
        base = np.cumprod(1.0 - make_betas(cfg))
        use = sorted(use_timesteps)
        new_betas, last = [], 1.0
        for t in use:
            new_betas.append(1 - base[t] / last)
            last = base[t]
        return cls(tuple(new_betas)), np.asarray(use)

    def tables(self) -> Dict[str, torch.Tensor]:
        betas = np.asarray(self.betas, np.float64)
        alphas = 1.0 - betas
        ac = np.cumprod(alphas)
        ac_prev = np.append(1.0, ac[:-1])
        post_var = betas * (1.0 - ac_prev) / (1.0 - ac)
        tables = dict(
            betas=betas,
            log_betas=np.log(betas),
            sqrt_ac=np.sqrt(ac),
            sqrt_one_minus_ac=np.sqrt(1 - ac),
            sqrt_recip_ac=np.sqrt(1.0 / ac),
            sqrt_recipm1_ac=np.sqrt(1.0 / ac - 1),
            post_var=post_var,
            post_logvar=np.log(np.append(post_var[1], post_var[1:])),
            post_mean_c0=betas * np.sqrt(ac_prev) / (1.0 - ac),
            post_mean_ct=(1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac),
        )
        return {k: torch.from_numpy(v.astype(np.float32))
                for k, v in tables.items()}

    # -- q distributions ----------------------------------------------------

    def q_sample(self, x0, t, noise):
        tb = self.tables()
        nd = x0.dim()
        return (_extract(tb["sqrt_ac"], t, nd) * x0
                + _extract(tb["sqrt_one_minus_ac"], t, nd) * noise)

    def q_posterior(self, x0, xt, t):
        tb = self.tables()
        nd = x0.dim()
        mean = (_extract(tb["post_mean_c0"], t, nd) * x0
                + _extract(tb["post_mean_ct"], t, nd) * xt)
        return mean, _extract(tb["post_logvar"], t, nd)

    def predict_x0_from_eps(self, xt, t, eps):
        tb = self.tables()
        nd = xt.dim()
        return (_extract(tb["sqrt_recip_ac"], t, nd) * xt
                - _extract(tb["sqrt_recipm1_ac"], t, nd) * eps)

    # -- p distribution with learned-range variance -------------------------

    def p_mean_variance(self, model_out, xt, t, clip_denoised: bool = False):
        """model_out (B, 2C, ...) -> (mean, logvar, x0). LEARNED_RANGE:
        logvar = frac * log(beta_t) + (1 - frac) * log(post_var_t)."""
        tb = self.tables()
        nd = xt.dim()
        c = xt.shape[1]
        eps, var_v = model_out[:, :c], model_out[:, c:]
        min_log = _extract(tb["post_logvar"], t, nd)
        max_log = _extract(tb["log_betas"], t, nd)
        frac = (var_v.float() + 1) / 2
        logvar = frac * max_log + (1 - frac) * min_log
        x0 = self.predict_x0_from_eps(xt, t, eps.float())
        if clip_denoised:
            x0 = x0.clamp(-1, 1)
        mean, _ = self.q_posterior(x0, xt, t)
        return mean, logvar, x0

    # -- losses -------------------------------------------------------------

    def vb_terms(self, model_out, x0, xt, t):
        """KL(q(x_{t-1}|x_t,x0) || p(x_{t-1}|x_t)) in bits, the discretized
        NLL at t = 0; the mean half is detached, so the VB term trains only
        the variance head (IDDPM)."""
        true_mean, true_logvar = self.q_posterior(x0, xt, t)
        c = x0.shape[1]
        frozen = torch.cat([model_out[:, :c].detach(), model_out[:, c:]], 1)
        mean, logvar, _ = self.p_mean_variance(frozen, xt, t)
        dims = tuple(range(1, x0.dim()))
        kl = normal_kl(true_mean, true_logvar, mean, logvar).mean(dims) / math.log(2.0)
        nll = -discretized_gaussian_log_likelihood(x0, mean, 0.5 * logvar)
        nll = nll.mean(dims) / math.log(2.0)
        return torch.where(t == 0, nll, kl)

    def training_losses(self, model_fn: Callable, x0: torch.Tensor,
                        t: torch.Tensor, noise: Optional[torch.Tensor] = None,
                        learn_sigma: bool = True,
                        generator: Optional[torch.Generator] = None):
        """MSE(eps) (+ VB with learn_sigma); model_fn(xt, t) -> (B, C or
        2C, ...). `noise` (x0's shape, float32) is drawn from `generator`
        when not given. Returns (loss, {"mse", "vb", "loss"})."""
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                device=x0.device)
        xt = self.q_sample(x0.float(), t, noise)
        out = model_fn(xt.to(x0.dtype), t)
        c = x0.shape[1]
        dims = tuple(range(1, x0.dim()))
        mse = (out[:, :c].float() - noise).square().mean(dims)
        total = mse
        aux = {"mse": mse.detach().mean()}
        if learn_sigma:
            vb = self.vb_terms(out, x0.float(), xt, t)
            total = total + vb
            aux["vb"] = vb.detach().mean()
        loss = total.mean()
        aux["loss"] = loss.detach()
        return loss, aux

    # -- ancestral sampling step --------------------------------------------

    def p_sample(self, model_out, xt, t, generator=None, clip_denoised=True):
        mean, logvar, _ = self.p_mean_variance(model_out, xt, t, clip_denoised)
        noise = torch.randn(xt.shape, generator=generator, device=xt.device)
        nonzero = (t != 0).float().reshape(-1, *([1] * (xt.dim() - 1)))
        return mean + nonzero * torch.exp(0.5 * logvar) * noise


def normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2).square() * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                   * (x + 0.044715 * x.pow(3))))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    """log p(x) for x in [-1, 1] discretized to 255 bins (IDDPM)."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp_min(1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp_min(1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp_min(1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_delta))


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """IDDPM respacing spec ('ddimN' or comma counts) -> timestep subset."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            want = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == want:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {want} steps with ddim")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start, out = 0, []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if count > size:
            raise ValueError(f"cannot divide section of {size} into {count}")
        stride = 1 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            out.append(start + round(cur))
            cur += stride
        start += size
    return set(out)
