"""Parity of the port's control path with the JAX package: the MMDiT's
three conditioning inputs (control_latents, ref_latents,
clip_encoder_hidden_states), the control pipeline (control video +
reference image; camera Plücker video without a reference, where the
zeros branch runs), the Plücker embedding and the video loader, and the
loading of a control model directory.

The MMDiT holds JAX's forward at 1e-5 on numpy draws from a seed; the
pipelines run the shapes of JAX's tests/test_inpaint.py:128-179 (tiny
MMDiT, the 2-block MagViT, 32x32x5f, CFG 3, 2 steps) in float32 from JAX's
noise, handed to the port, to LATENT_TOL = 5e-4. Weights cross from the
port to JAX through the reference-layout dicts; each pipeline pair is
built once per module.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.data import camera as jcamera
from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.models.mmdit import EasyAnimateTransformer3D as JaxModel
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu.pipeline import schedulers as jsched
from easyanimate_tpu.pipeline.control import \
    EasyAnimateControlPipeline as JaxControlPipeline
from easyanimate_tpu.pipeline.t2v import build_rope as jax_build_rope
from easyanimate_tpu.utils import media as jmedia
from easyanimate_tpu_torch import loader
from easyanimate_tpu_torch.data import camera as tcamera
from easyanimate_tpu_torch.models.convert import (init_random_,
                                                  load_reference_state_dict,
                                                  mmdit_config_json,
                                                  save_reference_checkpoint)
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.models.vae import AutoencoderKLMagvit
from easyanimate_tpu_torch.pipeline.control import EasyAnimateControlPipeline
from easyanimate_tpu_torch.pipeline.t2v import build_rope
from easyanimate_tpu_torch.ui.controller import EasyAnimateController
from easyanimate_tpu_torch.utils import media as tmedia
from tests.test_torch_mmdit import port_mmdit_cfg
from tests.test_torch_pipeline import LATENT_TOL
from tests.test_torch_safetensors import write_vae_and_scheduler
from tests.test_torch_serving import _random_weights
from tests.test_torch_vae import port_vae_cfg

# tests/test_inpaint.py's TINY_VAE: 2 blocks, spatial compression 2
JAX_VAE = jmagvit.MagvitVAEConfig(
    latent_channels=4, block_out_channels=(8, 16),
    down_block_types=("SpatialTemporalDownBlock3D", "SpatialDownBlock3D"),
    up_block_types=("SpatialTemporalUpBlock3D", "SpatialUpBlock3D"),
    layers_per_block=1, norm_num_groups=4, mini_batch_encoder=2,
    mini_batch_decoder=1, scaling_factor=0.5)
H = W = 32
FRAMES, STEPS = 5, 2
MMDIT_TOL = dict(rtol=1e-5, atol=1e-5)


def _pose_rows(n, seed):
    """n RealEstate10K rows: a forward dolly with a slow yaw and jitter."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        yaw = 0.02 * i + 0.01 * rng.standard_normal()
        rot = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                        [-np.sin(yaw), 0, np.cos(yaw)]])
        w2c = np.concatenate([rot, [[0.1 * rng.standard_normal()], [0.0],
                                    [-0.05 * i]]], axis=1)
        rows.append([i, 0.47 + 0.01 * rng.random(), 0.84, 0.5, 0.5, 0, 0,
                     *w2c.reshape(-1)])
    return rows


def _write_poses(path, rows):
    with open(path, "w") as f:
        f.write("https://www.youtube.com/watch?v=example\n")
        for r in rows:
            f.write(" ".join(repr(float(x)) for x in r) + "\n")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def test_plucker_and_pose_file_match_jax(tmp_path):
    path = str(tmp_path / "poses.txt")
    _write_poses(path, _pose_rows(7, 0))
    for h, w, kw in ((24, 40, {}), (40, 24, {}),
                     (16, 16, dict(original_pose_width=640,
                                   original_pose_height=640))):
        got = tcamera.plucker_from_file(path, h, w, **kw)
        want = jcamera.plucker_from_file(path, h, w, **kw)
        assert got.shape == (7, h, w, 6) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    poses = tcamera.read_pose_file(path)
    np.testing.assert_allclose(tcamera.relative_c2w(poses),
                               jcamera.relative_c2w(
                                   jcamera.read_pose_file(path)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tcamera.relative_c2w(poses)[0], np.eye(4))


def test_video_to_video_latent_matches_jax(rng):
    """Frames at the sample size (no PIL) and frames resized by PIL, a
    clip shorter than video_length (zero-padded) and one longer (cut),
    with and without a mask."""
    mask = (rng.random((H, W)) > 0.5).astype(np.float32)
    for frames, length, m in (((FRAMES, H, W), FRAMES, None),
                              ((3, 20, 28), FRAMES, mask),
                              ((9, H, W), FRAMES, mask)):
        clip = rng.integers(0, 256, (*frames, 3), dtype=np.uint8)
        got = tmedia.get_video_to_video_latent(clip, length, (H, W), m)
        want = jmedia.get_video_to_video_latent(clip, length, (H, W), m)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the MMDiT's conditioning inputs
# ---------------------------------------------------------------------------


def test_mmdit_conditioning_inputs_match_jax(rng):
    """control_latents after the latents on the channel axis, ref_latents
    replacing the text tokens (ref_proj + 2-D sin-cos), and
    clip_encoder_hidden_states prepended to them, alone and together."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], in_channels=4 + 8,
                               ref_channels=4, clip_channels=8)
    model = EasyAnimateTransformer3D(port_mmdit_cfg(jcfg), device="cpu")
    params = jconvert.convert_mmdit_state_dict(_random_weights(model, 3), jcfg)
    apply = jax.jit(JaxModel(jcfg).apply)
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)
    lat, ctl = draw(2, 4, 2, 8, 8), draw(2, 8, 2, 8, 8)
    ref, clip = draw(2, 4, 1, 8, 8), draw(2, 3, 8)
    txt, t = draw(2, 5, 24), np.array([700.0, 20.0], np.float32)
    rope = jax_build_rope(jcfg, 64, 64, 2)
    trope = build_rope(model.cfg, 64, 64, 2, device="cpu")
    for extra in ({}, {"ref_latents": ref},
                  {"clip_encoder_hidden_states": clip},
                  {"ref_latents": ref, "clip_encoder_hidden_states": clip}):
        want = apply(params, jnp.asarray(lat), jnp.asarray(t),
                     jnp.asarray(txt), rope, control_latents=jnp.asarray(ctl),
                     **{k: jnp.asarray(v) for k, v in extra.items()})
        with torch.no_grad():
            got = model(torch.from_numpy(lat), torch.from_numpy(t),
                        torch.from_numpy(txt), trope,
                        control_latents=torch.from_numpy(ctl),
                        **{k: torch.from_numpy(v) for k, v in extra.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MMDIT_TOL)
    # JAX's exporter gives back the reference dict of a control model
    # (the 12-channel proj, ref_proj, clip_proj), which loads strictly
    back = EasyAnimateTransformer3D(model.cfg, device="cpu")
    load_reference_state_dict(back,
                              jconvert.export_mmdit_state_dict(params, jcfg))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back.state_dict()[k], v, rtol=0, atol=0)
    # the table replaces nothing but the text: a ref shaped unlike the video
    with torch.no_grad():
        _, tok, _ = model.embed(torch.from_numpy(lat), torch.from_numpy(t),
                                torch.from_numpy(txt),
                                control_latents=torch.from_numpy(ctl),
                                ref_latents=torch.zeros(2, 4, 1, 4, 6),
                                clip_encoder_hidden_states=torch.zeros(2, 3, 8))
    assert tok.shape == (2, 3 + 2 * 3, model.cfg.inner_dim)


# ---------------------------------------------------------------------------
# the control pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vae_pair():
    vae = AutoencoderKLMagvit(port_vae_cfg(JAX_VAE), device="cpu")
    vparams = jconvert.convert_vae_state_dict(_random_weights(vae, 0),
                                              JAX_VAE)
    return jmagvit.AutoencoderKLMagvit(JAX_VAE), vparams, vae


_PAIRS = {}


def control_pair(kind, vae_pair):
    """(JAX pipeline, port pipeline) of a control model with the reference
    branch: in_channels 4 + 4 + 4 for a control video, 4 + 6 + 4 for the
    camera; built once per module for each kind."""
    if kind not in _PAIRS:
        jcfg = dataclasses.replace(
            JAX_PRESETS["tiny"], out_channels=4,
            in_channels=4 + (4 if kind == "video" else 6) + 4,
            add_ref_latent_in_control_model=True)
        model = EasyAnimateTransformer3D(port_mmdit_cfg(jcfg), device="cpu")
        params = jconvert.convert_mmdit_state_dict(
            _random_weights(model, 4 if kind == "video" else 5), jcfg)
        jvae, vparams, vae = vae_pair
        _PAIRS[kind] = (JaxControlPipeline(transformer=JaxModel(jcfg),
                                           vae=jvae, transformer_params=params,
                                           vae_params=vparams),
                        EasyAnimateControlPipeline(model, vae, "cpu"))
    return _PAIRS[kind]


def _inputs(kind, seed):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((1, 6, 24)).astype(np.float32)
    if kind == "video":
        return pos, {"control_video": rng.random(
            (1, 3, FRAMES, H, W)).astype(np.float32),
                     "ref_image": rng.random((1, 3, 1, H, W)).astype(
                         np.float32)}
    cam = jcamera.plucker_embedding(
        [jcamera.CameraPose.from_entry(r) for r in _pose_rows(FRAMES, seed)],
        H, W)
    return pos, {"control_camera_video":
                 np.ascontiguousarray(cam.transpose(3, 0, 1, 2)[None])}


@pytest.mark.parametrize("kind", ["video", "camera"])
def test_control_pipeline_matches_jax(kind, vae_pair):
    """Video + reference: both encoded, concatenated after the latents.
    Camera: the Plücker video resized to the latent grid x6 and zeros in
    the reference's place."""
    jpipe, pipe = control_pair(kind, vae_pair)
    pos, ins = _inputs(kind, 8)
    key = jax.random.PRNGKey(2)
    noise = np.array(jax.random.normal(key, pipe.latent_shape(
        1, FRAMES, H, W), jnp.float32))
    kw = dict(height=H, width=W, video_length=FRAMES,
              num_inference_steps=STEPS, guidance_scale=3.0,
              output_type="latent")
    want = np.asarray(jpipe(jnp.asarray(pos), jnp.zeros((1, 6, 24)), rng=key,
                            **{k: jnp.asarray(v) for k, v in ins.items()},
                            **kw))
    seen = {}

    def keep_control(module, args, kwargs, out):
        seen.setdefault("control", kwargs["control_latents"])

    hook = pipe.transformer.register_forward_hook(keep_control,
                                                  with_kwargs=True)
    got = pipe(torch.from_numpy(pos), torch.zeros(1, 6, 24),
               latents=torch.from_numpy(noise), **ins, **kw)
    hook.remove()
    ctl = seen["control"]
    assert ctl.shape == (2, pipe.transformer.cfg.in_channels - 4,
                         *noise.shape[2:])
    torch.testing.assert_close(ctl[0], ctl[1], rtol=0, atol=0)
    if kind == "camera":
        assert not ctl[:, 6:].any()
    else:
        assert ctl[:, 4:, :1].abs().max() > 0 and not ctl[:, 4:, 1:].any()
    np.testing.assert_allclose(got.numpy(), want, atol=LATENT_TOL,
                               rtol=LATENT_TOL)


def test_control_teacache_never_skip_equals_plain(vae_pair):
    """TeaCache at -1e9 computes every step: the gated loop, which embeds
    the control latents through embed(**cond), gives the plain latents."""
    _, pipe = control_pair("video", vae_pair)
    pos, ins = _inputs("video", 9)
    kw = dict(height=H, width=W, video_length=FRAMES, num_inference_steps=3,
              guidance_scale=3.0, output_type="latent",
              latents=torch.from_numpy(np.random.default_rng(9).standard_normal(
                  pipe.latent_shape(1, FRAMES, H, W)).astype(np.float32)))
    args = (torch.from_numpy(pos), torch.zeros(1, 6, 24))
    plain = pipe(*args, control_video=ins["control_video"], **kw)
    tea = pipe(*args, control_video=ins["control_video"],
               teacache_threshold=-1e9, **kw)
    assert pipe.last_teacache_skips == 0
    torch.testing.assert_close(tea, plain, rtol=1e-5, atol=1e-5)


def test_controller_passes_control_inputs_and_samplers(vae_pair):
    """generate(control_video=..., ref_image=...) reaches the control
    pipeline as the pipeline's own call does; a request with a sampler runs
    it, the next one without returns to the model's FlowMatch."""
    _, pipe = control_pair("video", vae_pair)
    pos, ins = _inputs("video", 10)
    ctl = EasyAnimateController(pipeline=pipe,
                                encode_text=lambda p: torch.from_numpy(pos))
    kw = dict(sample_steps=2, width=W, height=H, video_length=FRAMES,
              cfg_scale=3.0, seed=4, output_type="latent")
    got = ctl.generate(prompt="a", **ins, **kw)
    want = pipe(torch.from_numpy(pos), torch.from_numpy(pos), height=H,
                width=W, video_length=FRAMES, num_inference_steps=2,
                guidance_scale=3.0, output_type="latent",
                generator=torch.Generator().manual_seed(4), **ins)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    default = pipe.scheduler
    euler = ctl.generate(prompt="a", sampler="Euler", **ins, **kw)
    assert type(pipe.scheduler).__name__ == "EulerConfig"
    assert (euler - got).abs().max() > 1e-3
    torch.testing.assert_close(ctl.generate(prompt="a", **ins, **kw), got,
                               rtol=0, atol=0)
    assert pipe.scheduler is default


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def test_control_directory_loads_strictly(tmp_path):
    """A tiny Control-Camera directory written by the port (proj with 4 + 6
    + 4 input channels, ref_proj) loads with strict=True through
    load_pipeline(..., "control") and serves a camera request; a DDIM
    scheduler_config.json gives JAX's DDIMConfig, and the loader's other
    scheduler strings follow JAX's rule."""
    cfg = dataclasses.replace(port_mmdit_cfg(JAX_PRESETS["tiny"]),
                              in_channels=14, out_channels=4,
                              add_ref_latent_in_control_model=True)
    gen = torch.Generator().manual_seed(0)
    model = init_random_(EasyAnimateTransformer3D(cfg, device="cpu"), gen)
    vae = init_random_(AutoencoderKLMagvit(port_vae_cfg(JAX_VAE),
                                           device="cpu"), gen)
    root = str(tmp_path / "EasyAnimateV5.1-12b-zh-Control-Camera")
    save_reference_checkpoint(os.path.join(root, "transformer"),
                              model.state_dict(), mmdit_config_json(cfg),
                              max_shard_bytes=40_000)
    write_vae_and_scheduler(root, vae.cfg, vae.state_dict())
    pipe = loader.load_pipeline(root, "control", dtype="float32",
                                device="cpu")
    assert isinstance(pipe, EasyAnimateControlPipeline)
    assert pipe.transformer.proj.weight.shape[1] == 14
    for k, v in model.state_dict().items():
        torch.testing.assert_close(pipe.transformer.state_dict()[k], v,
                                   rtol=0, atol=0)
    _, ins = _inputs("camera", 11)
    out = pipe(torch.zeros(1, 6, 24), torch.zeros(1, 6, 24), height=H,
               width=W, video_length=FRAMES, num_inference_steps=1,
               guidance_scale=3.0, output_type="latent",
               generator=torch.Generator().manual_seed(0), **ins)
    assert out.shape == (1, 4, 3, H // 2, W // 2) and torch.isfinite(out).all()

    ddim_json = {"_class_name": "DDIMScheduler", "num_train_timesteps": 800,
                 "beta_start": 0.00085, "beta_end": 0.012,
                 "beta_schedule": "linear", "prediction_type": "v_prediction"}
    with open(os.path.join(root, "scheduler", "scheduler_config.json"),
              "w") as f:
        json.dump(ddim_json, f)
    want = jsched.DDIMConfig(**{k: v for k, v in ddim_json.items()
                                if not k.startswith("_")})
    got = loader._scheduler(root, None)
    assert type(got).__name__ == "DDIMConfig"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(loader._scheduler(root, "ddim")) == \
        dataclasses.asdict(want)
    # "flow" reads the config's fields; any other string is FlowMatch's
    # defaults (JAX's quirk)
    assert loader._scheduler(root, "flow") == loader.FlowMatchEulerConfig(
        num_train_timesteps=800)
    assert loader._scheduler(root, "euler") == loader.FlowMatchEulerConfig()
    assert isinstance(loader.load_pipeline(root, "control", dtype="float32",
                                           device="cpu").scheduler,
                      loader.DDIMConfig)
