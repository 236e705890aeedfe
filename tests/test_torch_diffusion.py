"""The port's IDDPM math (utils/diffusion.py) and the 'ddpm' / 'sigma'
losses of make_loss_fn against the JAX package, from the same timesteps
and noise.

Tolerances: DIFF_TOL for the diffusion formulas (float32 tables computed
in float64, the same element-wise formulas); LOSS_TOL relative for the
losses through the tiny MMDiT (float32 sums in another order), and
GRAD_TOL of the largest gradient for its gradients (the bound of
tests/test_torch_training.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.models.mmdit import EasyAnimateTransformer3D as JaxModel
from easyanimate_tpu.pipeline.schedulers import DDIMConfig as JDDIMConfig
from easyanimate_tpu.training import losses as jlosses
from easyanimate_tpu.training import trainer as jtrainer
from easyanimate_tpu.utils import diffusion as jdiff
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.ops.rope import (get_3d_rotary_pos_embed,
                                            get_resize_crop_region_for_grid)
from easyanimate_tpu_torch.pipeline.schedulers import DDIMConfig
from easyanimate_tpu_torch.training import trainer as ttrainer
from easyanimate_tpu_torch.utils import diffusion as tdiff
from tests.test_torch_mmdit import port_mmdit_cfg
from tests.test_torch_serving import _random_weights

DIFF_TOL = 1e-5
LOSS_TOL = 1e-4
GRAD_TOL = 5e-4


def _np(x):
    return np.asarray(x.detach() if torch.is_tensor(x) else x)


def _close(got, want, tol, atol=None):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                               atol=tol if atol is None else atol)


@pytest.mark.parametrize("schedule", ["linear", "scaled_linear"])
def test_q_sample_and_training_losses_match_jax(schedule, rng):
    kw = dict(num_train_timesteps=100, beta_schedule=schedule)
    jgd = jdiff.GaussianDiffusion.from_config(JDDIMConfig(**kw))
    tgd = tdiff.GaussianDiffusion.from_config(DDIMConfig(**kw))
    assert tgd.betas == jgd.betas
    x0 = np.clip(rng.standard_normal((3, 4, 2, 5, 5)), -1, 1).astype(np.float32)
    x0[0, 0, 0, 0, :2] = (-1.0, 1.0)  # the discretized NLL's edge bins
    t = np.array([0, 1, 99])          # t = 0 takes the NLL, else the KL
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, x0.shape, jnp.float32))
    _close(tgd.q_sample(torch.from_numpy(x0), torch.from_numpy(t),
                        torch.from_numpy(noise)),
           jgd.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise)),
           DIFF_TOL)
    w = rng.standard_normal((8, 4)).astype(np.float32) * 0.3

    def model(xp, xt, ti):  # a fixed function of (xt, t) with 2C channels
        lin = xp.einsum("bcthw,oc->bothw", xt,
                        torch.from_numpy(w) if xp is torch else w)
        return xp.tanh(lin) + 1e-3 * ti.reshape(-1, 1, 1, 1, 1)

    for learn_sigma in (False, True):
        wl, wa = jgd.training_losses(
            lambda xt, ti: model(jnp, xt, ti.astype(jnp.float32))[
                :, :None if learn_sigma else 4],
            jnp.asarray(x0), jnp.asarray(t), key, learn_sigma=learn_sigma)
        gl, ga = tgd.training_losses(
            lambda xt, ti: model(torch, xt, ti.float())[
                :, :None if learn_sigma else 4],
            torch.from_numpy(x0), torch.from_numpy(t),
            torch.from_numpy(noise), learn_sigma=learn_sigma)
        _close(gl, wl, DIFF_TOL)
        assert set(ga) == set(wa)
        for k in wa:
            _close(ga[k], wa[k], DIFF_TOL)


def test_diffusion_helpers_match_jax(rng):
    a, b, c, d = (rng.standard_normal((2, 6)).astype(np.float32)
                  for _ in range(4))
    _close(tdiff.normal_kl(*map(torch.from_numpy, (a, b, c, d))),
           jdiff.normal_kl(*map(jnp.asarray, (a, b, c, d))), DIFF_TOL)
    x = np.array([-1.0, -0.5, 0.0, 0.7, 1.0], np.float32)
    m = rng.standard_normal(5).astype(np.float32) * 0.1
    s = np.full(5, -2.0, np.float32)
    _close(tdiff.discretized_gaussian_log_likelihood(
               *map(torch.from_numpy, (x, m, s))),
           jdiff.discretized_gaussian_log_likelihood(*map(jnp.asarray, (x, m, s))),
           DIFF_TOL)
    for spec in ("ddim10", "10,5", "1,2,3"):
        assert tdiff.space_timesteps(100, spec) == jdiff.space_timesteps(100, spec)
    use = sorted(tdiff.space_timesteps(100, "ddim10"))
    cfg = dict(num_train_timesteps=100)
    tgd, tmap = tdiff.GaussianDiffusion.spaced(DDIMConfig(**cfg), use)
    jgd, jmap = jdiff.GaussianDiffusion.spaced(JDDIMConfig(**cfg), use)
    np.testing.assert_array_equal(tmap, jmap)
    np.testing.assert_allclose(tgd.betas, jgd.betas, rtol=1e-12)


@pytest.mark.parametrize("loss_type", ["ddpm", "sigma"])
def test_ddpm_losses_on_the_mmdit_match_jax(loss_type, rng):
    """make_loss_fn's 'ddpm' / 'sigma' branch on the tiny MMDiT ('sigma'
    predicts [eps, v] over 8 channels), banded timesteps from the JAX
    loss's own key split; loss, aux and gradients."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], attn_impl="xla",
                               out_channels=8 if loss_type == "sigma" else 4)
    port = EasyAnimateTransformer3D(port_mmdit_cfg(jcfg), device="cpu")
    variables = jconvert.convert_mmdit_state_dict(
        _random_weights(port, 5), jcfg)
    model = JaxModel(jcfg)
    f, hh, ww = 2, 8, 8
    lat = rng.standard_normal((2, 4, f, hh, ww)).astype(np.float32)
    txt = rng.standard_normal((2, 5, jcfg.text_embed_dim)).astype(np.float32)
    crop = get_resize_crop_region_for_grid((hh // 2, ww // 2), 45, 30)
    rope = get_3d_rotary_pos_embed(jcfg.attention_head_dim, crop,
                                   (hh // 2, ww // 2), f)
    jbatch = {"latents": jnp.asarray(lat), "text": jnp.asarray(txt),
              "rope": tuple(map(jnp.asarray, rope))}
    tbatch = {"latents": torch.from_numpy(lat), "text": torch.from_numpy(txt),
              "rope": tuple(map(torch.from_numpy, rope))}
    kw = dict(loss_type=loss_type)
    jt = jtrainer.TrainConfig(**kw, loss=jlosses.FlowMatchLossConfig(
        uniform_bands=2))
    tt = ttrainer.TrainConfig(**kw, loss=ttrainer.FlowMatchLossConfig(
        uniform_bands=2))
    key = jax.random.PRNGKey(11)
    rng_t, rng_n = jax.random.split(key)  # trainer.py:297, 317-323
    t = jlosses.ddpm_sample_timesteps(rng_t, 2, 1000, 2)
    draws = ttrainer.DDPMDraws(
        torch.from_numpy(np.array(t)),
        torch.from_numpy(np.array(jax.random.normal(rng_n, lat.shape,
                                                    jnp.float32))))
    jloss = jtrainer.make_loss_fn(model, jt)
    (wl, wa), wg = jax.jit(jax.value_and_grad(
        lambda p: jloss(p, jbatch, key), has_aux=True))(variables["params"])
    gl, ga = ttrainer.make_loss_fn(port, tt)(tbatch, draws)
    _close(gl, wl, LOSS_TOL, 0)
    assert set(ga) == set(wa)
    for k in wa:
        _close(ga[k], wa[k], LOSS_TOL, 1e-7)
    gl.backward()
    want = jconvert.export_mmdit_state_dict({"params": wg}, jcfg)
    scale = max(np.abs(w).max() for w in want.values())
    for name, p in port.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        _close(g, want[name], GRAD_TOL, GRAD_TOL * scale)
    # the step draws its own timesteps and noise from a generator
    step = ttrainer.make_train_step(port, tt)
    state, metrics = step(ttrainer.create_train_state(port, tt), tbatch,
                          generator=torch.Generator().manual_seed(0))
    assert state.step == 1 and torch.isfinite(metrics["loss"])
