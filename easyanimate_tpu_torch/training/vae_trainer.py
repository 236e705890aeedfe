"""VAE (MagViT) GAN training: two optimizers, alternating steps.

Parity: easyanimate_tpu/training/vae_trainer.py (reference
AutoencoderKLMagvit_fromOmnigen.training_step / configure_optimizers,
vae/ldm/models/omnigen_casual3dcnn.py:258-339): `ae_step` and `disc_step`
share the loss pieces of vae_losses.py; Adam with b1 0.5, b2 0.9 on each;
optional EMA of the VAE. The adaptive GAN weight takes the gradient norms
of the NLL and of the generator loss with respect to the decoder's last
conv (`decoder.conv_out.weight`), as the reference's get_last_layer.

The JAX step reconstructs three times from one key (the same z each
time); the port reconstructs once and takes both last-layer gradients
with torch.autograd.grad(..., retain_graph=True): the same numbers for a
third of the work. The parameters live in the modules (float32, as JAX
trains them); the state holds them by name, the optimizer states and the
EMA. The encoder's sample draw is handed in (`noise`, the moments' mean
shape) or drawn from a torch.Generator.
"""
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..models.vae import AutoencoderKLMagvit, gaussian_sample
from . import optim
from .vae_losses import (VAELossConfig, adaptive_gan_weight, hinge_d_loss,
                         hinge_g_loss, kl_and_outlier_loss,
                         reconstruction_loss)

LAST_LAYER = "decoder.conv_out.weight"


@dataclasses.dataclass
class VAETrainState:
    step: int
    vae_params: Dict[str, torch.Tensor]   # the VAE's own parameters
    disc_params: Dict[str, torch.Tensor]  # the discriminator's
    vae_opt: Any
    disc_opt: Any
    ema_params: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass(frozen=True)
class VAETrainConfig:
    learning_rate: float = 1e-4
    disc_learning_rate: float = 1e-4
    use_ema: bool = False
    ema_decay: float = 0.9999
    loss: VAELossConfig = dataclasses.field(default_factory=VAELossConfig)


def _adam(lr: float) -> optim.GradientTransformation:
    """optax.adam(lr, b1=0.5, b2=0.9)."""
    return optim.chain(optim.scale_by_adam(0.5, 0.9, 1e-8),
                       optim.scale_by_learning_rate(lambda count: lr))


def create_vae_train_state(vae: nn.Module, disc: nn.Module,
                           cfg: VAETrainConfig) -> VAETrainState:
    vae_params = dict(vae.named_parameters())
    disc_params = dict(disc.named_parameters())
    return VAETrainState(
        step=0, vae_params=vae_params, disc_params=disc_params,
        vae_opt=_adam(cfg.learning_rate).init(vae_params),
        disc_opt=_adam(cfg.disc_learning_rate).init(disc_params),
        ema_params=({n: p.detach().clone() for n, p in vae_params.items()}
                    if cfg.use_ema else None))


def _grads(loss, params: Dict[str, torch.Tensor], **kw):
    got = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                              **kw)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), got)}


def make_vae_train_steps(
    vae: AutoencoderKLMagvit,
    disc: nn.Module,
    cfg: VAETrainConfig,
    lpips_apply: Optional[Callable] = None,
) -> Tuple[Callable, Callable]:
    """Returns (ae_step, disc_step), each step(state, batch, generator=None,
    noise=None) -> (state, aux); batch = {"video": (B, C, T, H, W) in
    [-1, 1]}. LPIPS (`lpips_apply`), if given, should have frozen
    parameters."""
    vae_tx = _adam(cfg.learning_rate)
    disc_tx = _adam(cfg.disc_learning_rate)
    lcfg = cfg.loss

    def reconstruct(video, generator, noise):
        moments, _ = vae.encode_chunk(video, None)
        z = gaussian_sample(moments, generator, noise)
        recon, _ = vae.decode_chunk(z, None)
        return recon, moments

    def ae_step(state: VAETrainState, batch, generator=None, noise=None):
        video = batch["video"]
        recon, moments = reconstruct(video, generator, noise)
        rec, aux = reconstruction_loss(lcfg, video, recon, lpips_apply)
        kl = kl_and_outlier_loss(lcfg, moments)
        nll = rec + kl
        g = hinge_g_loss(disc(recon))
        # the adaptive weight from the last layer's gradient norms
        last = state.vae_params[LAST_LAYER]
        (g_nll,) = torch.autograd.grad(nll, last, retain_graph=True)
        (g_gan,) = torch.autograd.grad(g, last, retain_graph=True)
        d_weight = adaptive_gan_weight(torch.linalg.vector_norm(g_nll),
                                       torch.linalg.vector_norm(g_gan),
                                       lcfg.disc_weight)
        disc_on = float(state.step >= lcfg.disc_start)
        loss = nll + disc_on * d_weight * g
        grads = _grads(loss, state.vae_params)
        aux.update({"kl": kl.detach(), "g_loss": g.detach(),
                    "d_weight": d_weight, "loss": loss.detach()})
        aux = {k: v.detach() for k, v in aux.items()}
        updates, new_opt = vae_tx.update(grads, state.vae_opt,
                                         state.vae_params)
        optim.apply_updates(state.vae_params, updates)
        if state.ema_params is not None:
            d = cfg.ema_decay
            with torch.no_grad():
                for n, e in state.ema_params.items():
                    e.copy_(d * e + (1 - d) * state.vae_params[n])
        return dataclasses.replace(state, step=state.step + 1,
                                   vae_opt=new_opt), aux

    def disc_step(state: VAETrainState, batch, generator=None, noise=None):
        video = batch["video"]
        with torch.no_grad():
            recon, _ = reconstruct(video, generator, noise)
        loss = hinge_d_loss(disc(video), disc(recon))
        disc_on = float(state.step >= lcfg.disc_start)
        grads = {n: g * disc_on
                 for n, g in _grads(loss, state.disc_params).items()}
        updates, new_opt = disc_tx.update(grads, state.disc_opt,
                                          state.disc_params)
        optim.apply_updates(state.disc_params, updates)
        return dataclasses.replace(state, disc_opt=new_opt), {
            "disc_loss": loss.detach()}

    return ae_step, disc_step
