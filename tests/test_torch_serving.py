"""Parity of the port's serving knobs with the JAX package: TeaCache
(teacache_gate, the per-model polynomials, the gated denoise loop),
cfg_split and cfg_skip_ratio in the T2V and inpaint pipelines, with and
without swa_layers, and the decode variants (4:2:0 planes, the overlapped
chunk decode).

The tiny MMDiT (6 heads, dense or with SWA layer 1) and the tiny MagViT of
tests/test_torch_pipeline.py at 64x64x5f, float32, with the port's random
weights crossed to JAX through the reference-layout dicts; both packages
start from the same numpy latents (and, for the inpaint pipeline, the same
I2V video and mask, no noise augmentation). Final latents agree to
LATENT_TOL = 5e-4, the full-model bound. TeaCache's skip pattern is a
threshold decision: the intermediate threshold is taken between two
accumulator values of JAX's run at 1e9, and JAX's own accumulators at that
threshold (read through a wrapper of its gate) are checked to lie at least
1% away from it, so float32 rounding cannot flip a decision between the
packages.
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
from easyanimate_tpu.pipeline import t2v as jt2v
from easyanimate_tpu_torch import loader
from easyanimate_tpu_torch.models.convert import (init_random_,
                                                  load_reference_state_dict)
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.models.vae import AutoencoderKLMagvit, vae_decode
from easyanimate_tpu_torch.pipeline import t2v as tt2v
from easyanimate_tpu_torch.pipeline.inpaint import EasyAnimateInpaintPipeline
from easyanimate_tpu_torch.utils.media import get_image_to_video_latent
from tests.test_torch_mmdit import port_mmdit_cfg
from tests.test_torch_pipeline import LATENT_TOL
from tests.test_torch_safetensors import write_tiny_model_dir
from tests.test_torch_vae import JAX_TINY_VAE, port_vae_cfg

H = W = 64
FRAMES, STEPS = 5, 5
KINDS = [("t2v", None), ("t2v", (1,)), ("inpaint", None), ("inpaint", (1,))]


def _random_weights(module, seed):
    """init_random_ (N(0, 1/fan_in), unit norms, zero biases), then every
    tensor perturbed so biases and norm affines are exercised too."""
    gen = torch.Generator().manual_seed(seed)
    init_random_(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def vae_pair():
    """The tiny MagViT: the port's random weights, converted for JAX by its
    own reference-dict converter (faster than a JAX init)."""
    vae = AutoencoderKLMagvit(port_vae_cfg(JAX_TINY_VAE), device="cpu")
    vparams = jconvert.convert_vae_state_dict(_random_weights(vae, 0),
                                              JAX_TINY_VAE)
    return jmagvit.AutoencoderKLMagvit(JAX_TINY_VAE), vparams, vae


_PAIRS = {}


def pair(kind, swa, vae_pair):
    """(JAX pipeline, port pipeline, inputs) on the same tiny weights,
    built once per module for each (kind, swa_layers). The inpaint noise is
    JAX's draw from its key (JAX's inpaint pipeline takes no latents)."""
    if (kind, swa) not in _PAIRS:
        inpaint = kind == "inpaint"
        jcfg = dataclasses.replace(JAX_PRESETS["tiny"], num_attention_heads=6,
                                   swa_layers=swa,
                                   in_channels=9 if inpaint else 4)
        model = EasyAnimateTransformer3D(port_mmdit_cfg(jcfg), device="cpu")
        jparams = jconvert.convert_mmdit_state_dict(
            _random_weights(model, 1 if inpaint else 2), jcfg)
        jvae, vparams, vae = vae_pair
        jcls = (jinpaint.EasyAnimateInpaintPipeline if inpaint
                else jt2v.EasyAnimatePipeline)
        jpipe = jcls(transformer=JaxModel(jcfg), vae=jvae,
                     transformer_params=jparams, vae_params=vparams)
        cls = (EasyAnimateInpaintPipeline if inpaint
               else tt2v.EasyAnimatePipeline)
        pipe = cls(model, vae, "cpu")
        rng = np.random.default_rng(1)
        shape = pipe.latent_shape(1, FRAMES, H, W)
        ins = dict(lat0=rng.standard_normal(shape).astype(np.float32),
                   pos=rng.standard_normal((1, 6, 24)).astype(np.float32))
        if inpaint:
            image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            ins["video"], ins["mask"] = get_image_to_video_latent(
                image, None, FRAMES, (H, W))
            ins["key"] = jax.random.PRNGKey(3)
            ins["lat0"] = np.array(jax.random.normal(
                jax.random.split(ins["key"])[0], shape, jnp.float32))
        _PAIRS[kind, swa] = jpipe, pipe, ins
    return _PAIRS[kind, swa]


def run_both(jpipe, pipe, ins, steps=STEPS, **knobs):
    """Final latents of both packages (numpy) and their skip counts."""
    kw = dict(height=H, width=W, video_length=FRAMES,
              num_inference_steps=steps, guidance_scale=6.0,
              output_type="latent", **knobs)
    pos, neg = ins["pos"], np.zeros_like(ins["pos"])
    jkw, tkw = dict(kw), dict(kw)
    if "video" in ins:
        jkw.update(video=jnp.asarray(ins["video"]),
                   mask_video=jnp.asarray(ins["mask"]), noise_aug_strength=0.0,
                   rng=ins["key"])
        tkw.update(video=ins["video"], mask_video=ins["mask"],
                   noise_aug_strength=0.0)
    lat_j = np.asarray(jpipe(jnp.asarray(pos), jnp.asarray(neg),
                             latents=jnp.asarray(ins["lat0"]), **jkw))
    lat_t = pipe(torch.from_numpy(pos), torch.from_numpy(neg),
                 latents=torch.from_numpy(ins["lat0"]), **tkw).numpy()
    skips_j = getattr(jpipe, "last_teacache_skips", None)
    return (lat_j, lat_t, None if skips_j is None else int(skips_j),
            pipe.last_teacache_skips)


def test_teacache_gate_and_coefficients_match_jax(rng):
    mod = rng.standard_normal((2, 7, 12)).astype(np.float32)
    prev = mod + 0.3 * rng.standard_normal(mod.shape).astype(np.float32)
    for idx, acc, thr in ((0, 0.0, 0.1), (2, 0.05, 0.1), (2, 0.05, 5.0),
                          (4, 0.3, 5.0), (3, -0.2, 0.0)):
        for coef in (tt2v.TEACACHE_COEFFICIENTS,
                     tt2v.get_teacache_coefficients("v5.1-7b")):
            want = jt2v.teacache_gate(jnp.asarray(mod), jnp.asarray(prev),
                                      jnp.float32(acc), idx, 5, thr, coef)
            got = tt2v.teacache_gate(torch.from_numpy(mod),
                                     torch.from_numpy(prev),
                                     torch.tensor(acc), idx, 5, thr, coef)
            assert bool(got[0]) == bool(want[0])
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g.item(), float(w), rtol=1e-5,
                                           atol=1e-6)
    for name in ("alibaba-pai/EasyAnimateV5.1-12b-zh",
                 "models/EasyAnimateV5.1-12b-zh-InP", "EasyAnimateV5.1-7b-zh",
                 "EasyAnimateV5-12b-zh", "anything"):
        assert (tt2v.get_teacache_coefficients(name)
                == jt2v.get_teacache_coefficients(name))


def test_loader_sets_coefficients_by_path(tmp_path, capsys):
    """load_pipeline takes the polynomial of the model path, as JAX's
    loader does; a model without one serves TeaCache requests on the plain
    path, with one message per pipeline."""
    pipes = {}
    for name in ("EasyAnimateV5.1-12b-zh", "EasyAnimateV5.1-7b-zh-InP",
                 "my-model"):
        root = str(tmp_path / name)
        write_tiny_model_dir(root)
        pipes[name] = loader.load_pipeline(root, dtype="float32",
                                           device="cpu")
        assert (pipes[name].teacache_coefficients
                == tt2v.get_teacache_coefficients(root))
    assert pipes["my-model"].teacache_coefficients is None
    pipe = pipes["my-model"]
    kw = dict(height=32, width=32, video_length=5, num_inference_steps=3,
              latents=torch.randn(1, 4, 3, 16, 16,
                                  generator=torch.Generator().manual_seed(0)),
              output_type="latent", guidance_scale=6.0)
    pos = torch.randn(1, 6, 24, generator=torch.Generator().manual_seed(1))
    plain = pipe(pos, torch.zeros_like(pos), **kw)
    capsys.readouterr()
    for _ in range(2):
        got = pipe(pos, torch.zeros_like(pos), teacache_threshold=0.1, **kw)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)
        assert pipe.last_teacache_skips is None
    assert capsys.readouterr().out.count("TeaCache disabled") == 1


@pytest.mark.parametrize("kind,swa", [("t2v", None), ("inpaint", (1,))])
def test_teacache_below_every_accumulator_is_the_plain_path(kind, swa,
                                                            vae_pair):
    """At threshold -1e9 every step computes: the gated loop (embed, gate,
    backbone, head) gives the plain forward's latents."""
    _, pipe, ins = pair(kind, swa, vae_pair)
    pos = torch.from_numpy(ins["pos"])
    kw = dict(height=H, width=W, video_length=FRAMES, num_inference_steps=3,
              latents=torch.from_numpy(ins["lat0"]), output_type="latent")
    if "video" in ins:
        kw.update(video=ins["video"], mask_video=ins["mask"],
                  noise_aug_strength=0.0)
    plain = pipe(pos, torch.zeros_like(pos), **kw)
    gated = pipe(pos, torch.zeros_like(pos), teacache_threshold=-1e9, **kw)
    assert pipe.last_teacache_skips == 0
    torch.testing.assert_close(gated, plain, rtol=1e-5, atol=1e-5)


def _recording_gate(monkeypatch):
    """Wrap JAX's gate so each step's accumulator before the reset, acc +
    poly(rel), reaches the host; the gate's results are unchanged."""
    seen = []
    gate = jt2v.teacache_gate

    def wrapped(mod, prev_mod, acc, idx, n_steps, threshold, coefficients):
        should, rel, acc_out = gate(mod, prev_mod, acc, idx, n_steps,
                                    threshold, coefficients)
        acc_new = acc + jnp.polyval(jnp.asarray(coefficients), rel)
        jax.debug.callback(lambda i, a: seen.append((int(i), float(a))),
                           idx, acc_new)
        return should, rel, acc_out

    monkeypatch.setattr(jt2v, "teacache_gate", wrapped)
    return seen


@pytest.mark.parametrize("kind,swa", KINDS)
def test_teacache_matches_jax(kind, swa, vae_pair, monkeypatch):
    """At 1e9 every interior step is skipped; at a threshold between the
    accumulator after steps 1 and 2 some are. The port skips as many steps
    as JAX and lands within LATENT_TOL."""
    jpipe, pipe, ins = pair(kind, swa, vae_pair)
    seen = _recording_gate(monkeypatch)
    lat_j, lat_t, skips_j, skips_t = run_both(jpipe, pipe, ins,
                                              teacache_threshold=1e9)
    assert skips_j == skips_t == STEPS - 2
    np.testing.assert_allclose(lat_t, lat_j, atol=LATENT_TOL, rtol=LATENT_TOL)

    acc = dict(sorted(seen))
    threshold = (acc[1] + acc[2]) / 2
    seen.clear()
    lat_j, lat_t, skips_j, skips_t = run_both(jpipe, pipe, ins,
                                              teacache_threshold=threshold)
    interior = [a for i, a in seen if 0 < i < STEPS - 1]
    assert len(interior) == STEPS - 2
    assert all(abs(a - threshold) >= 0.01 * abs(threshold) for a in interior)
    assert 0 < skips_j < STEPS - 2
    assert skips_t == skips_j
    np.testing.assert_allclose(lat_t, lat_j, atol=LATENT_TOL, rtol=LATENT_TOL)


@pytest.mark.parametrize("kind,swa", KINDS)
def test_cfg_split_matches_batched_and_jax(kind, swa, vae_pair):
    jpipe, pipe, ins = pair(kind, swa, vae_pair)
    lat_j, lat_t, _, _ = run_both(jpipe, pipe, ins, steps=3, cfg_split=True)
    np.testing.assert_allclose(lat_t, lat_j, atol=LATENT_TOL, rtol=LATENT_TOL)
    pos = torch.from_numpy(ins["pos"])
    kw = dict(height=H, width=W, video_length=FRAMES, num_inference_steps=3,
              latents=torch.from_numpy(ins["lat0"]), output_type="latent")
    if "video" in ins:
        kw.update(video=ins["video"], mask_video=ins["mask"],
                  noise_aug_strength=0.0)
    batched = pipe(pos, torch.zeros_like(pos), **kw).numpy()
    np.testing.assert_allclose(lat_t, batched, atol=LATENT_TOL,
                               rtol=LATENT_TOL)


@pytest.mark.parametrize("kind,swa,ratio,threshold", [
    ("t2v", None, 0.0, None), ("t2v", None, 0.5, None),
    ("t2v", None, 1.0, None), ("t2v", (1,), 0.4, 1e9),
    ("inpaint", None, 0.4, 1e9), ("inpaint", (1,), 0.5, None)])
def test_cfg_skip_ratio_matches_jax(kind, swa, ratio, threshold, vae_pair):
    """The last round(ratio * 5) steps run cond-only (2 at 0.4 and 0.5);
    with TeaCache at 1e9 the skipped step 3 reuses the positive half of the
    CFG batch's residual. Ratio 1.0 is guidance off."""
    jpipe, pipe, ins = pair(kind, swa, vae_pair)
    knobs = dict(cfg_skip_ratio=ratio, teacache_threshold=threshold)
    lat_j, lat_t, skips_j, skips_t = run_both(jpipe, pipe, ins, **knobs)
    np.testing.assert_allclose(lat_t, lat_j, atol=LATENT_TOL, rtol=LATENT_TOL)
    assert skips_t == skips_j
    if ratio == 1.0:
        pos = torch.from_numpy(ins["pos"])
        off = pipe(pos, None, height=H, width=W, video_length=FRAMES,
                   num_inference_steps=STEPS, guidance_scale=1.0,
                   latents=torch.from_numpy(ins["lat0"]), output_type="latent")
        np.testing.assert_allclose(lat_t, off.numpy(), rtol=1e-6, atol=1e-6)


def test_decode_latents_yuv420_matches_jax(vae_pair):
    """The 4:2:0 planes within 1 of JAX's (a value within the float32
    difference of a rounding boundary), and their shapes and dtype."""
    jpipe, pipe, _ = pair("t2v", None, vae_pair)
    lat = np.random.default_rng(2).standard_normal((1, 4, 2, 8, 8)).astype(
        np.float32)
    want = jpipe.decode_latents_yuv420(jnp.asarray(lat))
    got = pipe.decode_latents_yuv420(torch.from_numpy(lat))
    assert [p.shape for p in got] == [(1, 5, H, W)] + [
        (1, 5, H // 2, W // 2)] * 2
    for g, w in zip(got, want):
        assert g.dtype == np.uint8
        assert np.abs(g.astype(np.int16) - np.asarray(w, np.int16)).max() <= 1


def test_decode_latents_overlapped_equals_the_untiled_decode(vae_pair):
    """Chunk by chunk (frame 0, then 2 latent frames a chunk, the last one
    ragged), each chunk's host copy started as it is queued: bit-equal to
    the untiled vae_decode with the same decode_chunk_frames."""
    _, _, vae = vae_pair
    vae = AutoencoderKLMagvit(dataclasses.replace(vae.cfg,
                                                  decode_chunk_frames=2),
                              device="cpu")
    load_reference_state_dict(vae, vae_pair[2].state_dict())
    pipe = tt2v.EasyAnimatePipeline(pair("t2v", None, vae_pair)[1].transformer,
                                    vae, "cpu")
    lat = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 4, 4, 8, 8)).astype(np.float32))
    with torch.inference_mode():
        video = vae_decode(vae, lat / vae.cfg.scaling_factor)
    want = torch.round((video / 2 + 0.5).clamp(0.0, 1.0) * 255.0).to(
        torch.uint8).numpy()
    got = pipe.decode_latents_overlapped(lat)
    assert got.shape == (1, 3, 13, H, W) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pipe.decode_latents(lat,
                                                           to_uint8=True))


def test_output_types_and_smooth(vae_pair):
    """output_type="device" keeps the float video as a tensor, decode=False
    returns the latents, smooth=True runs smooth_output (here through the
    cache_mag protocol) where JAX runs it, matching JAX's, and is ignored
    where JAX ignores it."""
    jpipe, pipe, ins = pair("t2v", None, vae_pair)
    pos = torch.from_numpy(ins["pos"])
    kw = dict(height=H, width=W, video_length=FRAMES, num_inference_steps=1,
              latents=torch.from_numpy(ins["lat0"]))
    lat = pipe(pos, torch.zeros_like(pos), output_type="latent", **kw)
    for args in (dict(output_type="np", decode=False),
                 dict(output_type="latent")):
        torch.testing.assert_close(pipe(pos, torch.zeros_like(pos), **args,
                                        **kw), lat, rtol=0, atol=0)
    video = pipe(pos, torch.zeros_like(pos), output_type="device", **kw)
    assert torch.is_tensor(video) and video.dtype == torch.float32
    np.testing.assert_array_equal(video.numpy(), pipe.decode_latents(lat))
    assert not pipe.smooth_default() and not jpipe.smooth_default()
    smoothed = pipe.decode_latents(lat, smooth=True)
    np.testing.assert_allclose(
        smoothed, jpipe.decode_latents(jnp.asarray(lat.numpy()), smooth=True),
        atol=LATENT_TOL, rtol=LATENT_TOL)
    assert np.abs(smoothed - video.numpy()).max() > 1e-3
    np.testing.assert_array_equal(  # one frame: no seams
        pipe.decode_latents(lat[:, :, :1], smooth=True),
        pipe.decode_latents(lat[:, :, :1]))
    with pytest.raises(ValueError, match="output_type"):
        pipe(pos, torch.zeros_like(pos), output_type="mp4", **kw)
