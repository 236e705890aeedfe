"""Parity of the PyTorch port's MagViT VAE (easyanimate_tpu_torch.models
.vae) with the JAX package: group norm, the causal conv cache (stride 1 and
2), the tiny VAE decode at decode_chunk_frames 1 and 4 and tiled, the
encoder and its cache_mag `vae_encode`, whole and tiled.

Weights cross as the reference-layout dict that the JAX package exports;
the port loads the whole dict strictly. Both sides run in float32 from the
same numpy inputs. Tolerance 5e-4 for the decoder and the encoder (the
full-model bound of tests/test_mmdit_full_golden.py: a deep stack of
convolutions summed in another order), 1e-5 for one norm or conv.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu.models.vae.layers import group_norm as jax_group_norm
from easyanimate_tpu_torch.models.convert import load_reference_state_dict
from easyanimate_tpu_torch.models.vae import (AutoencoderKLMagvit,
                                              MagvitVAEConfig, gaussian_mode,
                                              gaussian_sample, vae_decode,
                                              vae_decode_tiled, vae_encode,
                                              vae_encode_tiled)
from easyanimate_tpu_torch.models.vae.layers import CausalConv3d, group_norm

VAE_TOL = 5e-4
# the decoder geometry of the verify recipe: 4 blocks, 8 groups
JAX_TINY_VAE = jmagvit.MagvitVAEConfig(
    latent_channels=4, block_out_channels=(32, 64, 128, 128),
    norm_num_groups=8)


def port_vae_cfg(jcfg) -> MagvitVAEConfig:
    return MagvitVAEConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(MagvitVAEConfig)})


def export_jax_vae(jcfg, seed=0):
    """Init the JAX VAE (encoder included) and export its reference dict;
    norm affines and biases perturbed so they are exercised."""
    vae = jmagvit.AutoencoderKLMagvit(jcfg)
    params = jax.jit(vae.init)(jax.random.PRNGKey(seed),
                               jnp.zeros((1, 1, 8, 8, 3)))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(a.dtype),
        params)
    return vae, params, jconvert.export_vae_state_dict(params, jcfg)


@pytest.fixture(scope="module")
def tiny_vae():
    vae, params, sd = export_jax_vae(JAX_TINY_VAE)
    port = AutoencoderKLMagvit(port_vae_cfg(JAX_TINY_VAE), device="cpu")
    load_reference_state_dict(port, sd)
    return vae, params, sd, port


def _close(got, want, tol=VAE_TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("spatial", [True, False])
def test_group_norm_matches_jax(rng, spatial):
    x = rng.standard_normal((2, 16, 3, 5, 6)).astype(np.float32) * 2 + 1
    w = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    want = jax_group_norm(jnp.asarray(x.transpose(0, 2, 3, 4, 1)),
                          jnp.asarray(w), jnp.asarray(b), 4, 1e-6, spatial)
    got = group_norm(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(b), 4, 1e-6, spatial)
    _close(got.permute(0, 2, 3, 4, 1), want, 1e-5)


def test_causal_conv_chunked_equals_full(rng):
    conv = CausalConv3d(3, 5)
    x = torch.from_numpy(rng.standard_normal((1, 3, 7, 6, 6)).astype(np.float32))
    with torch.no_grad():
        full, _ = conv(x)
        y0, cache = conv(x[:, :, :1])
        y1, cache = conv(x[:, :, 1:4], cache)
        y2, _ = conv(x[:, :, 4:], cache)
    _close(torch.cat([y0, y1, y2], dim=2), full.numpy(), 1e-5)


@pytest.mark.parametrize("chunk", [1, 4])
def test_tiny_decode_matches_jax(rng, tiny_vae, chunk):
    """3 latent frames -> 9 video frames through the cache_mag protocol."""
    vae_j, params, _, port = tiny_vae
    port.cfg = dataclasses.replace(port_vae_cfg(JAX_TINY_VAE),
                                   decode_chunk_frames=chunk)
    z = rng.standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    want = jmagvit.vae_decode(vae_j, params, jnp.asarray(z))
    with torch.no_grad():
        got = vae_decode(port, torch.from_numpy(z))
    assert got.shape == (1, 3, 9, 32, 32)
    _close(got, want)


@pytest.fixture(scope="module")
def variant_vae():
    """The variant geometry's JAX VAE and the port's on its exported
    weights, shared by the variant encode and decode cases (the decode
    runs 2 latent frames a pass)."""
    jcfg = jmagvit.MagvitVAEConfig(
        latent_channels=4, block_out_channels=(16, 16, 16),
        down_block_types=("SpatialDownBlock3D", "TemporalDownBlock3D",
                          "SpatialTemporalDownBlock3D"),
        up_block_types=("SpatialTemporalUpBlock3D", "TemporalUpBlock3D",
                        "SpatialUpBlock3D"),
        norm_num_groups=4, spatial_group_norm=False,
        mid_block_attention_type="temporal", decode_chunk_frames=2)
    vae_j, params, sd = export_jax_vae(jcfg, seed=1)
    port = AutoencoderKLMagvit(port_vae_cfg(jcfg), device="cpu")
    load_reference_state_dict(port, sd)
    return vae_j, params, port


def test_variant_decode_matches_jax(rng, variant_vae):
    """The decoder's other paths: a temporal up block (first-frame rule +
    trilinear 2x), whole-clip group norm with the trilinear
    spatial-temporal upsampler, and temporal mid-block attention."""
    vae_j, params, port = variant_vae
    z = rng.standard_normal((1, 4, 3, 4, 4)).astype(np.float32)
    want = jmagvit.vae_decode(vae_j, params, jnp.asarray(z))
    with torch.no_grad():
        got = vae_decode(port, torch.from_numpy(z))
    assert got.shape == (1, 3, 9, 8, 8)
    _close(got, want)


def test_tiled_decode_matches_jax(rng, tiny_vae):
    """Tiles of 24 px (3 latents) over a 4x5 latent: a 2x2 grid of
    overlapping tiles with blended seams, end-aligned last tiles."""
    _, params, _, port = tiny_vae
    jcfg = dataclasses.replace(JAX_TINY_VAE, tile_sample_min_size=24,
                               decode_chunk_frames=4)
    vae_j = jmagvit.AutoencoderKLMagvit(jcfg)
    port.cfg = port_vae_cfg(jcfg)
    z = rng.standard_normal((1, 4, 2, 4, 5)).astype(np.float32)
    want = jmagvit.vae_decode_tiled(vae_j, params, jnp.asarray(z))
    with torch.no_grad():
        got = vae_decode_tiled(port, torch.from_numpy(z))
    assert got.shape == (1, 3, 5, 32, 40)
    _close(got, want)


def test_vae_loads_decoder_subset_strictly(tiny_vae):
    """The whole exported dict loads strictly, encoder included: a missing
    decoder or encoder key raises, as does an extra one."""
    _, _, sd, port = tiny_vae
    assert any(k.startswith(("encoder.", "quant_conv.")) for k in sd)
    for key in ("decoder.up_blocks.1.upsampler.conv.weight",
                "encoder.down_blocks.1.downsampler.conv.weight",
                "quant_conv.bias"):
        missing = {k: v for k, v in sd.items() if k != key}
        with pytest.raises(RuntimeError, match="Missing"):
            load_reference_state_dict(port, missing)
    extra = dict(sd, **{"decoder.bogus.weight": np.zeros(1, np.float32)})
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_reference_state_dict(port, extra)
    load_reference_state_dict(port, sd)


def test_full_vae_config_matches_jax():
    jcfg = jmagvit.MagvitVAEConfig()
    cfg = port_vae_cfg(jcfg)
    assert cfg == MagvitVAEConfig()
    assert (cfg.spatial_compression, cfg.temporal_compression) == (8, 4)
    assert jmagvit.latent_frame_count(49, jcfg) == 13
    port = AutoencoderKLMagvit(cfg, device="meta")
    want = set(jconvert._magvit_mapping(jcfg))
    got = set(port.state_dict())
    assert any(k.startswith("encoder.down_blocks.2.downsampler") for k in got)
    # the mapping lists a shortcut for every residual block; only blocks
    # that change width have one
    assert got <= want
    assert all(".shortcut." in k for k in want - got)


@pytest.mark.parametrize("stride,spad", [(2, ((0, 1), (0, 1))),
                                         ((2, 1, 1), None)])
def test_stride2_causal_conv_chunked_equals_full(rng, stride, spad):
    """A temporal stride-2 conv takes one fewer cached frame, so frame 0
    alone, then chunks of 4, equals the whole clip (9 frames -> 5)."""
    conv = CausalConv3d(3, 5, stride=stride, spatial_padding=spad,
                        device="cpu")
    x = torch.from_numpy(rng.standard_normal((1, 3, 9, 6, 6)).astype(np.float32))
    with torch.no_grad():
        full, _ = conv(x)
        y0, cache = conv(x[:, :, :1])
        y1, cache = conv(x[:, :, 1:5], cache)
        y2, _ = conv(x[:, :, 5:], cache)
    assert full.shape[2] == 5
    _close(torch.cat([y0, y1, y2], dim=2), full.numpy(), 1e-5)


def test_tiny_encode_matches_jax(rng, tiny_vae):
    """9 frames -> 3 latent frames through the cache_mag protocol (frame 0,
    then chunks of mini_batch_encoder = 4 frames), and the same moments
    from one pass over the whole clip."""
    vae_j, params, _, port = tiny_vae
    port.cfg = port_vae_cfg(JAX_TINY_VAE)
    x = rng.uniform(-1, 1, (1, 3, 9, 32, 32)).astype(np.float32)
    want = jmagvit.vae_encode(vae_j, params, jnp.asarray(x))
    with torch.no_grad():
        got = vae_encode(port, torch.from_numpy(x))
        whole, _ = port.encode_chunk(torch.from_numpy(x))
    assert got.shape == (1, 8, 3, 4, 4)
    _close(got, want)
    _close(whole, got.numpy(), 1e-5)
    _close(gaussian_mode(got), np.asarray(jmagvit.gaussian_mode(want, axis=1)),
           VAE_TOL)


def test_variant_encode_matches_jax(rng, variant_vae):
    """The encoder's other paths: a temporal down block (stride (2, 1, 1),
    symmetric spatial padding), whole-clip group norm, temporal mid-block
    attention."""
    vae_j, params, port = variant_vae
    x = rng.uniform(-1, 1, (1, 3, 9, 16, 16)).astype(np.float32)
    want = jmagvit.vae_encode(vae_j, params, jnp.asarray(x))
    with torch.no_grad():
        got = vae_encode(port, torch.from_numpy(x))
    assert got.shape == (1, 8, 5, 8, 8)
    _close(got, want)


def test_tiled_encode_matches_jax(rng, tiny_vae):
    """Tiles of 24 px over 32 x 40 pixels: a 2 x 2 grid of overlapping
    tiles, blended seams, end-aligned last tiles."""
    _, params, _, port = tiny_vae
    jcfg = dataclasses.replace(JAX_TINY_VAE, tile_sample_min_size=24)
    vae_j = jmagvit.AutoencoderKLMagvit(jcfg)
    port.cfg = port_vae_cfg(jcfg)
    x = rng.uniform(-1, 1, (1, 3, 5, 32, 40)).astype(np.float32)
    want = jmagvit.vae_encode_tiled(vae_j, params, jnp.asarray(x))
    with torch.no_grad():
        got = vae_encode_tiled(port, torch.from_numpy(x))
    assert got.shape == (1, 8, 2, 4, 5)
    _close(got, want)


def test_gaussian_sample_draws_around_the_mode():
    mean = torch.full((1, 4, 1, 64, 64), 2.0)
    logvar = torch.full_like(mean, 2 * np.log(0.5))
    moments = torch.cat([mean, logvar], dim=1)
    assert torch.equal(gaussian_mode(moments), mean)
    z = gaussian_sample(moments, torch.Generator().manual_seed(0))
    assert z.shape == mean.shape
    assert abs(z.mean().item() - 2.0) < 0.02
    assert abs(z.std().item() - 0.5) < 0.02
    big = torch.cat([mean, torch.full_like(mean, 100.0)], dim=1)
    assert gaussian_sample(big).std().item() < np.exp(10.0) * 1.1  # clamp 20
