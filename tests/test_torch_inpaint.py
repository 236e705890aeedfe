"""Parity of the port's image/video-to-video slice with the JAX package:
the latent-grid mask resize, the reference-video noise augmentation, the
I2V input helper, and EasyAnimateInpaintPipeline.__call__ end to end --
I2V, V2V with strength 0.5, and T2V through an inpaint model -- from the
same numpy video, mask, noise and prompt embeddings.

Weights cross through the reference-layout dicts (the tiny MMDiT with
4 + 1 + 4 input channels, the tiny MagViT with its encoder): the port's
random weights, converted for JAX by its own convert_*_state_dict (much
faster than a JAX init; the JAX exporters' dicts are held against the port
in tests/test_torch_mmdit.py and tests/test_torch_vae.py). Both sides run
in float32; JAX's noise augmentation is off (noise_aug_strength=0), since
its draws are JAX's. Final latents agree to 5e-4 (the full-model bound of
tests/test_mmdit_full_golden.py), the uint8 video to 1 (a value within the
float32 difference of a rounding boundary), the mask resize to 1e-5.
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
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu.pipeline import inpaint as jinpaint
from easyanimate_tpu.utils import media as jmedia
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.models.vae import AutoencoderKLMagvit
from easyanimate_tpu_torch.pipeline import inpaint as tinpaint
from easyanimate_tpu_torch.utils import media as tmedia
from tests.test_torch_mmdit import port_mmdit_cfg
from tests.test_torch_serving import _random_weights
from tests.test_torch_vae import JAX_TINY_VAE, port_vae_cfg

LATENT_TOL = 5e-4
H = W = 64
FRAMES = 5


@pytest.mark.parametrize("first_frame_special", [True, False])
def test_resize_mask_to_latent_matches_jax(rng, first_frame_special):
    mask = (rng.random((1, 1, 9, 32, 40)) > 0.3).astype(np.float32)
    shape = (1, 4, 3, 4, 5)
    want = jinpaint.resize_mask_to_latent(jnp.asarray(mask), shape,
                                          first_frame_special)
    got = tinpaint.resize_mask_to_latent(torch.from_numpy(mask), shape,
                                         first_frame_special)
    assert got.shape == (1, 1, 3, 4, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_noise_aug_keeps_masked_pixels_and_draws_at_ratio(rng):
    video = torch.from_numpy(rng.uniform(-0.9, 1, (2, 3, 5, 64, 64))
                             .astype(np.float32))
    video[:, :, 1:] = -1.0
    out = tinpaint.add_noise_to_reference_video(
        video, torch.Generator().manual_seed(0), ratio=0.1)
    assert torch.equal(out[:, :, 1:], video[:, :, 1:])
    noise = (out - video)[:, :, :1]
    assert abs(noise.mean().item()) < 5e-3
    assert abs(noise.std().item() - 0.1) < 5e-3
    again = tinpaint.add_noise_to_reference_video(
        video, torch.Generator().manual_seed(0), ratio=0.1)
    assert torch.equal(out, again)
    # ratio None: one sigma ~ exp(N(-3, 0.5)) per sample
    drawn = tinpaint.add_noise_to_reference_video(
        video, torch.Generator().manual_seed(1))
    stds = (drawn - video)[:, :, :1].flatten(1).std(dim=1)
    assert torch.all((stds > np.exp(-6)) & (stds < np.exp(0)))


def test_get_image_to_video_latent_matches_jax(rng):
    """Arrays at the sample size (uint8, and float in [0, 1]) need no
    resize; another size goes through PIL's LANCZOS as in JAX."""
    start = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    end = rng.random((H, W, 3)).astype(np.float32)
    other = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    for a, b in ((start, None), (start, end), (None, end), (other, None)):
        got = tmedia.get_image_to_video_latent(a, b, FRAMES, (H, W))
        want = jmedia.get_image_to_video_latent(a, b, FRAMES, (H, W))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    video, mask = got
    assert video.shape == (1, 3, FRAMES, H, W) and mask.shape == (1, 1, FRAMES, H, W)


@pytest.fixture(scope="module")
def pipelines():
    """The JAX inpaint pipeline and the port's on the same tiny weights."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], num_attention_heads=6,
                               in_channels=4 + 1 + 4, out_channels=4)
    transformer = EasyAnimateTransformer3D(port_mmdit_cfg(jcfg), device="cpu")
    assert transformer.proj.weight.shape[1] == 9  # proj.weight: 33 at 12B
    jparams = jconvert.convert_mmdit_state_dict(
        _random_weights(transformer, 0), jcfg)
    vae = AutoencoderKLMagvit(port_vae_cfg(JAX_TINY_VAE), device="cpu")
    vparams = jconvert.convert_vae_state_dict(_random_weights(vae, 1),
                                              JAX_TINY_VAE)
    jpipe = jinpaint.EasyAnimateInpaintPipeline(
        transformer=JaxModel(jcfg), vae=jmagvit.AutoencoderKLMagvit(
            JAX_TINY_VAE), transformer_params=jparams, vae_params=vparams)
    return jpipe, tinpaint.EasyAnimateInpaintPipeline(transformer, vae)


@pytest.mark.parametrize("mode", ["i2v", "v2v", "t2v"])
def test_inpaint_pipeline_matches_jax(rng, pipelines, mode):
    """I2V (start image, mask on frames 1..4), V2V at strength 0.5 (4
    steps from t_start 2, no mask) and T2V through the inpaint model (zero
    mask and masked latents), CFG 6."""
    jpipe, pipe = pipelines
    assert pipe.device == torch.device("cpu")
    pos = rng.standard_normal((1, 6, 24)).astype(np.float32)
    neg = np.zeros_like(pos)
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    if mode == "i2v":
        video, mask = tmedia.get_image_to_video_latent(image, None, FRAMES,
                                                       (H, W))
        steps, strength = 3, 1.0
    elif mode == "v2v":
        video = rng.random((1, 3, FRAMES, H, W)).astype(np.float32)
        mask, steps, strength = None, 4, 0.5
    else:
        video = mask = None
        steps, strength = 3, 1.0
    key = jax.random.PRNGKey(3)
    shape = pipe.latent_shape(1, FRAMES, H, W)
    noise = np.array(jax.random.normal(jax.random.split(key)[0], shape,
                                         jnp.float32))
    kw = dict(height=H, width=W, video_length=FRAMES,
              num_inference_steps=steps, guidance_scale=6.0,
              strength=strength, noise_aug_strength=0.0)
    lat_j = jpipe(jnp.asarray(pos), jnp.asarray(neg),
                  video=None if video is None else jnp.asarray(video),
                  mask_video=None if mask is None else jnp.asarray(mask),
                  rng=key, output_type="latent", **kw)
    seen = []
    video_t = pipe(torch.from_numpy(pos), torch.from_numpy(neg), video=video,
                   mask_video=mask, latents=torch.from_numpy(noise),
                   output_type="uint8",
                   callback=lambda i, lat: seen.append(lat.clone()), **kw)
    assert len(seen) == (2 if mode == "v2v" else steps)
    np.testing.assert_allclose(seen[-1].numpy(), np.asarray(lat_j),
                               atol=LATENT_TOL, rtol=LATENT_TOL)
    video_j = jpipe.decode_latents(lat_j, to_uint8=True)
    assert video_t.dtype == np.uint8 and video_t.shape == (1, 3, FRAMES, H, W)
    diff = np.abs(video_t.astype(np.int16) - np.asarray(video_j, np.int16))
    assert diff.max() <= 1, diff.max()


def test_vae_encoded_mask_branch(rng):
    """Without resize_inpaint_mask_directly the mask goes in as VAE latents
    of its pixels 2 (1 - mask) - 1 (JAX inpaint.py:144-149): the
    transformer receives [those latents, masked-video latents], CFG-doubled,
    with latent_channels + latent_channels inpaint channels."""
    cfg = dataclasses.replace(port_mmdit_cfg(JAX_PRESETS["tiny"]),
                              in_channels=4 + 4 + 4, out_channels=4,
                              resize_inpaint_mask_directly=False)
    transformer = EasyAnimateTransformer3D(cfg, device="cpu")
    vae = AutoencoderKLMagvit(port_vae_cfg(JAX_TINY_VAE), device="cpu")
    pipe = tinpaint.EasyAnimateInpaintPipeline(transformer, vae)
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    video, mask = tmedia.get_image_to_video_latent(image, None, FRAMES, (H, W))
    seen = {}
    transformer.register_forward_hook(
        lambda m, args, kwargs, out: seen.setdefault("inpaint",
                                                     kwargs["inpaint_latents"]),
        with_kwargs=True)
    pipe(torch.zeros(1, 6, 24), torch.zeros(1, 6, 24), video=video,
         mask_video=mask, height=H, width=W, video_length=FRAMES,
         num_inference_steps=1, noise_aug_strength=0.0, output_type="latent")

    def encode(pix):
        with torch.no_grad():
            moments = tinpaint.vae_encode(vae, torch.from_numpy(pix))
        return tinpaint.gaussian_mode(moments) * vae.cfg.scaling_factor

    keep = (mask < 0.5).astype(np.float32)
    want = torch.cat([
        encode(np.broadcast_to(2 * (1 - mask) - 1, video.shape).copy()),
        encode((2 * video - 1) * keep - (1 - keep))], dim=1)
    got = seen["inpaint"]
    assert got.shape == (2, 8, 2, 8, 8)
    np.testing.assert_allclose(got[:1].numpy(), want.numpy(), atol=1e-6)
    assert torch.equal(got[:1], got[1:])
