"""Parity of the PyTorch port's text-to-video slice with the JAX package:
the flow-matching sampler pieces, and EasyAnimatePipeline.__call__ as a
whole -- CFG-batched denoise with guidance rescale, then the MagViT decode
to uint8 -- from the same numpy latents and prompt embeddings.

Both sides run in float32 with weights crossed through the reference-layout
dicts: the port's random weights, converted for JAX by its own
convert_*_state_dict (much faster than a JAX init; the JAX exporters'
dicts are held against the port in tests/test_torch_mmdit.py and
tests/test_torch_vae.py), the VAE and its JAX decode shared by the
parametrised cases. Final latents agree to 5e-4 (the full-model bound of
tests/test_mmdit_full_golden.py). The uint8 video may differ by 1: a pixel
whose value lands within the float32 difference of a rounding boundary
(k + 0.5) / 255 rounds to k on one side and k + 1 on the other.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.models.mmdit import EasyAnimateTransformer3D as JaxModel
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu.pipeline import schedulers as jsched
from easyanimate_tpu.pipeline.t2v import EasyAnimatePipeline as JaxPipeline
from easyanimate_tpu.pipeline.t2v import build_rope as jax_build_rope
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.models.vae import (AutoencoderKLMagvit,
                                              latent_frame_count)
from easyanimate_tpu_torch.pipeline import schedulers as tsched
from easyanimate_tpu_torch.pipeline.t2v import EasyAnimatePipeline, build_rope
from tests.test_torch_mmdit import port_mmdit_cfg
from tests.test_torch_vae import JAX_TINY_VAE, port_vae_cfg

LATENT_TOL = 5e-4


def test_flow_match_schedule_matches_jax():
    for steps in (1, 4, 25, 50):
        for a, b in zip(tsched.flow_match_schedule(
                tsched.FlowMatchEulerConfig(), steps),
                jsched.flow_match_schedule(jsched.FlowMatchEulerConfig(),
                                           steps)):
            np.testing.assert_array_equal(a, b)


def test_flow_step_and_cfg_rescale_match_jax(rng):
    x, v, text = (rng.standard_normal((2, 4, 3, 5, 5)).astype(np.float32)
                  for _ in range(3))
    np.testing.assert_allclose(
        tsched.flow_match_step(torch.from_numpy(x), torch.from_numpy(v),
                               0.75, 0.5).numpy(),
        np.asarray(jsched.flow_match_step(jnp.asarray(x), jnp.asarray(v),
                                          jnp.float32(0.75),
                                          jnp.float32(0.5))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tsched.rescale_noise_cfg(torch.from_numpy(v), torch.from_numpy(text),
                                 0.7).numpy(),
        np.asarray(jsched.rescale_noise_cfg(jnp.asarray(v), jnp.asarray(text),
                                            0.7)),
        atol=1e-5, rtol=1e-5)
    assert tsched.init_noise_sigma(tsched.FlowMatchEulerConfig(), 25) == 1.0


def test_build_rope_and_latent_shape_match_jax():
    cfg = JAX_PRESETS["v5.1-12b"]
    cos_j, sin_j = jax_build_rope(cfg, 384, 672, 13)
    cos_t, sin_t = build_rope(port_mmdit_cfg(cfg), 384, 672, 13, device="cpu")
    assert cos_t.shape == (13 * 24 * 42, 64)
    np.testing.assert_array_equal(cos_t.numpy(), np.asarray(cos_j))
    np.testing.assert_array_equal(sin_t.numpy(), np.asarray(sin_j))
    vae_cfg = port_vae_cfg(type(JAX_TINY_VAE)())
    assert latent_frame_count(49, vae_cfg) == 13
    pipe = EasyAnimatePipeline(None, AutoencoderKLMagvit(vae_cfg, device="meta"),
                               "meta")
    assert pipe.latent_shape(1, 49, 384, 672) == (1, 16, 13, 48, 84)


@pytest.fixture(scope="module")
def vae_pair():
    """The tiny MagViT (random weights) in both packages, and a JAX
    pipeline whose compiled decode every case shares."""
    from tests.test_torch_serving import _random_weights

    vae = AutoencoderKLMagvit(port_vae_cfg(JAX_TINY_VAE), device="cpu")
    vparams = jconvert.convert_vae_state_dict(_random_weights(vae, 0),
                                              JAX_TINY_VAE)
    jvae = jmagvit.AutoencoderKLMagvit(JAX_TINY_VAE)
    decoder = JaxPipeline(transformer=None, vae=jvae, vae_params=vparams,
                          transformer_params=None)
    return jvae, vparams, vae, decoder


@pytest.mark.parametrize("swa_layers", [None, (1,)])
def test_t2v_slice_matches_jax(rng, swa_layers, vae_pair):
    """Tiny MMDiT + tiny MagViT, 64x64x5f, 3 steps, CFG 6 with rescale."""
    from tests.test_torch_serving import _random_weights

    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], num_attention_heads=6,
                               swa_layers=swa_layers)
    transformer = EasyAnimateTransformer3D(port_mmdit_cfg(jcfg), device="cpu")
    jparams = jconvert.convert_mmdit_state_dict(
        _random_weights(transformer, 2), jcfg)
    jvae, vparams, vae, decoder = vae_pair
    jpipe = JaxPipeline(transformer=JaxModel(jcfg), vae=jvae,
                        transformer_params=jparams, vae_params=vparams)
    pipe = EasyAnimatePipeline(transformer, vae, "cpu")

    h = w = 64
    frames, steps = 5, 3
    shape = pipe.latent_shape(1, frames, h, w)
    assert shape == (1, 4, 2, 8, 8)
    lat0 = rng.standard_normal(shape).astype(np.float32)
    pos = rng.standard_normal((1, 6, jcfg.text_embed_dim)).astype(np.float32)
    neg = np.zeros_like(pos)
    kw = dict(height=h, width=w, video_length=frames,
              num_inference_steps=steps, guidance_scale=6.0,
              guidance_rescale=0.7)

    lat_j = jpipe(jnp.asarray(pos), jnp.asarray(neg), latents=jnp.asarray(lat0),
                  output_type="latent", **kw)
    video_j = decoder.decode_latents(lat_j, to_uint8=True)

    seen = []
    video_t = pipe(torch.from_numpy(pos), torch.from_numpy(neg),
                   latents=torch.from_numpy(lat0), output_type="uint8",
                   callback=lambda i, lat: seen.append(lat.clone()), **kw)
    assert len(seen) == steps
    assert all(not torch.equal(a, b) for a, b in zip([torch.from_numpy(lat0)]
                                                       + seen, seen))
    np.testing.assert_allclose(seen[-1].numpy(), np.asarray(lat_j),
                               atol=LATENT_TOL, rtol=LATENT_TOL)
    assert video_t.dtype == np.uint8 and video_t.shape == (1, 3, frames, h, w)
    diff = np.abs(video_t.astype(np.int16) - np.asarray(video_j, np.int16))
    assert diff.max() <= 1, diff.max()
