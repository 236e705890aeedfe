"""The port's training driver (easyanimate_tpu_torch.train) and its steps
on conditioned models, against the JAX package.

- The -InP and -Control steps: make_train_step and make_lora_train_step on
  tiny configs whose proj takes the inpaint (9) or control (8, 10 with the
  camera) channels, as examples/train.py:630-660 builds them, fed the same
  batch and draws as JAX's steps. Loss within LOSS_RTOL relative (float32
  sums in another order); updated parameters and factors within PARAM_ATOL
  absolute (float32; Adam's first update is about lr * sign(g)).
- _inpaint_latents and _camera_latents on the same arrays and draws as
  examples/train.py's, within 1e-5 (the tiny MagViT in float32).
- main(["--tiny_demo", ...], device="cpu") in-process in every mode the
  driver has, 2 steps, then a resume; `--help` in a process where jax,
  flax, easyanimate_tpu, orbax and safetensors cannot be imported.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.models.mmdit import EasyAnimateTransformer3D as JaxModel
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu.training import lora as jlora
from easyanimate_tpu.training import trainer as jtrainer
from easyanimate_tpu_torch import train as ttrain
from easyanimate_tpu_torch import train_lora as ttrain_lora
from easyanimate_tpu_torch.models.convert import (export_lora_state_dict,
                                                  init_random_,
                                                  load_lora_reference,
                                                  load_reference_lora_state_dict)
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.models.vae import (AutoencoderKLMagvit,
                                              gaussian_mode, vae_encode)
from easyanimate_tpu_torch.ops.rope import (get_3d_rotary_pos_embed,
                                            get_resize_crop_region_for_grid)
from easyanimate_tpu_torch.training import lora as tlora
from easyanimate_tpu_torch.training import trainer as ttrainer
from tests.test_torch_mmdit import port_mmdit_cfg
from tests.test_torch_serving import _random_weights
from tests.test_torch_training import _jax_draws
from tests.test_torch_vae import port_vae_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5
# the tiny MagViT of examples/train.py's --tiny_demo
DRIVER_TINY_VAE = dict(
    latent_channels=4, block_out_channels=(8, 16),
    down_block_types=("SpatialTemporalDownBlock3D", "SpatialDownBlock3D"),
    up_block_types=("SpatialTemporalUpBlock3D", "SpatialUpBlock3D"),
    layers_per_block=1, norm_num_groups=4, mini_batch_encoder=2,
    mini_batch_decoder=1)

# (proj input channels, conditioning key, its channels)
CONDITIONED = {"inpaint": (9, "inpaint_latents", 5),
               "control": (8, "control_latents", 4),
               "control_camera": (10, "control_latents", 6)}


def _conditioned_pair(kind, rng):
    """The tiny MMDiT with `kind`'s proj (XLA attention on the JAX side),
    the port's random weights crossed to JAX, and one batch for both."""
    in_ch, key, ch = CONDITIONED[kind]
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], in_channels=in_ch,
                               out_channels=4, attn_impl="xla")
    port = EasyAnimateTransformer3D(port_mmdit_cfg(jcfg), device="cpu")
    variables = jconvert.convert_mmdit_state_dict(
        _random_weights(port, in_ch), jcfg)
    f, hh, ww = 2, 8, 8
    arrs = {"latents": rng.standard_normal((1, 4, f, hh, ww)),
            "text": rng.standard_normal((1, 5, jcfg.text_embed_dim)),
            key: rng.standard_normal((1, ch, f, hh, ww))}
    arrs = {k: v.astype(np.float32) for k, v in arrs.items()}
    crop = get_resize_crop_region_for_grid((hh // 2, ww // 2), 45, 30)
    rope = get_3d_rotary_pos_embed(jcfg.attention_head_dim, crop,
                                   (hh // 2, ww // 2), f)
    jbatch = {k: jnp.asarray(v) for k, v in arrs.items()}
    jbatch["rope"] = tuple(map(jnp.asarray, rope))
    tbatch = {k: torch.from_numpy(v) for k, v in arrs.items()}
    tbatch["rope"] = tuple(map(torch.from_numpy, rope))
    return jcfg, JaxModel(jcfg), variables, port, jbatch, tbatch


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(
        np.asarray(got.detach() if torch.is_tensor(got) else got),
        np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", sorted(CONDITIONED))
def test_conditioned_sft_and_lora_steps_match_jax(kind, rng):
    """One SFT and one LoRA step on an -InP / -Control / -Control-Camera
    config: the port's steps feed the batch's conditioning latents to the
    model as JAX's do (trainer.py:281-288, lora.py:127-131)."""
    jcfg, model, variables, port, jbatch, tbatch = _conditioned_pair(kind, rng)
    tcfg_kw = dict(learning_rate=2e-5)
    jt, tt = jtrainer.TrainConfig(**tcfg_kw), ttrainer.TrainConfig(**tcfg_kw)
    key = jax.random.PRNGKey(7)
    draws = _jax_draws(key, jbatch["latents"], jt.loss)

    jstate = jtrainer.create_train_state(variables, jt)
    # JAX's CPU arrays may alias the port's memory (numpy views both ways):
    # its asynchronously dispatched step has to finish before the port's
    # updates its parameters in place
    jstate, jm = jax.block_until_ready(
        jax.jit(jtrainer.make_train_step(model, jt))(jstate, jbatch, key))
    tstate, tm = ttrainer.make_train_step(port, tt)(
        ttrainer.create_train_state(port, tt), tbatch, draws=draws)
    _close(tm["loss"], jm["loss"], LOSS_RTOL, 0)
    want = jconvert.export_mmdit_state_dict(jstate.params, jcfg)
    assert set(tstate.params) == set(want)
    for name, w in want.items():
        _close(tstate.params[name], w, 0, PARAM_ATOL)

    # LoRA on the weights as they were before the SFT step
    port.load_state_dict({k: torch.from_numpy(v) for k, v in
                          jconvert.export_mmdit_state_dict(variables, jcfg).items()})
    jlcfg, tlcfg = jlora.LoRAConfig(rank=4), tlora.LoRAConfig(rank=4)
    jinit, jstep = jlora.make_lora_train_step(model, jt, jlcfg, variables)
    jstep = jax.jit(jstep)
    jl = jinit(jax.random.PRNGKey(3))
    jl = jl.replace(params={  # a non-zero up: every factor gets a gradient
        p: {"down": f["down"], "up": 0.01 * jax.random.normal(
            jax.random.PRNGKey(i), f["up"].shape)}
        for i, (p, f) in enumerate(sorted(jl.params.items()))})
    lora, _ = load_reference_lora_state_dict(
        port, jconvert.export_lora_state_dict(jl.params, jlcfg.alpha, jcfg),
        device="cpu")
    tinit, tstep = tlora.make_lora_train_step(port, tt, tlcfg)
    jl, jm = jax.block_until_ready(jstep(jl, jbatch, key))
    tl, tm = tstep(tinit(lora=lora), tbatch, draws=draws)
    _close(tm["loss"], jm["loss"], LOSS_RTOL, 0)
    want = jconvert.export_lora_state_dict(jl.params, jlcfg.alpha, jcfg)
    got = export_lora_state_dict(tl.params, tlcfg.alpha)
    for name, w in want.items():
        _close(got[name], w, 0, PARAM_ATOL)


def test_text_t5_is_refused():
    """V5's text_t5 reaches the model (tests/test_torch_v5.py holds the V5
    steps against JAX); a model without a T5 stream refuses it."""
    cfg = dataclasses.replace(port_mmdit_cfg(JAX_PRESETS["tiny"]),
                              num_layers=1)
    lat, t = torch.zeros(1, 4, 1, 4, 4), torch.ones(1)
    batch = {"text": torch.ones(1, 3, cfg.text_embed_dim),
             "text_t5": torch.ones(1, 2, 8)}
    with pytest.raises(ValueError, match="T5 stream"):
        ttrainer.apply_model(EasyAnimateTransformer3D(cfg, device="cpu"),
                             lat, t, batch)
    v5 = EasyAnimateTransformer3D(dataclasses.replace(
        cfg, text_embed_dim_t5=8, add_norm_text_encoder=True), device="cpu")
    with torch.no_grad():
        with_t5 = ttrainer.apply_model(v5, lat, t, batch)
        without = ttrainer.apply_model(v5, lat, t, {"text": batch["text"]})
    assert with_t5.shape == lat.shape
    assert not torch.equal(with_t5, without)


# ---------------------------------------------------------------------------
# the driver's batch helpers against examples/train.py's
# ---------------------------------------------------------------------------


def _jax_driver():
    spec = importlib.util.spec_from_file_location(
        "ea_train_example", os.path.join(REPO, "examples", "train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_driver():
    return _jax_driver()


def test_inpaint_latents_match_jax(jax_driver, rng):
    """-1 fill, noise augmentation and the T2V zeroing from the same
    draws: sample 0 fully masked (zeroed: its flag draw < 0.9), sample 1
    fully masked (kept: its draw >= 0.9), samples 2-3 half masked."""
    from jax.sharding import Mesh

    jcfg = jmagvit.MagvitVAEConfig(**DRIVER_TINY_VAE)
    vae = AutoencoderKLMagvit(port_vae_cfg(jcfg), device="cpu")
    init_random_(vae, torch.Generator().manual_seed(0))
    vp = jconvert.convert_vae_state_dict(
        {k: v.numpy() for k, v in vae.state_dict().items()}, jcfg)
    jvae = jmagvit.AutoencoderKLMagvit(jcfg)
    scale = 0.7
    jenc = jax.jit(lambda p, x: jmagvit.gaussian_mode(
        jmagvit.vae_encode(jvae, p, x), axis=1) * scale)

    b, t, h, w = 4, 5, 16, 16
    pixels = (rng.random((b, 3, t, h, w)) * 2 - 1).astype(np.float32)
    masks = np.zeros((b, 1, t, h, w), np.float32)
    masks[:2] = 1.0
    masks[2:, :, :, h // 2:] = 1.0
    latents = np.array(jenc(vp, jnp.asarray(pixels)))
    cfg = dataclasses.replace(JAX_PRESETS["tiny"],
                              add_noise_in_inpaint_model=True)
    key = jax.random.PRNGKey(40)
    # the draws examples/train.py makes from `key`
    r_aug, r_flag = jax.random.split(key)
    r_sigma, r_noise = jax.random.split(r_aug)
    draws = ttrain.InpaintDraws(
        sigma=torch.from_numpy(np.array(jax.random.normal(r_sigma, (b,)))),
        noise=torch.from_numpy(np.array(jax.random.normal(
            r_noise, pixels.shape, jnp.float32))),
        flag=torch.from_numpy(np.array(jax.random.uniform(r_flag, (b,)))))
    assert float(draws.flag[0]) < 0.9 <= float(draws.flag[1])
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))

    @torch.no_grad()
    def tenc(x):
        return gaussian_mode(vae_encode(vae, x)) * scale

    for rng_key, tdraws in ((None, None), (key, draws)):
        with mesh:
            want = np.asarray(jax_driver._inpaint_latents(
                jvae, vp, {"mask": masks}, jnp.asarray(pixels),
                jnp.asarray(latents), scale, cfg, jenc, mesh, rng=rng_key))
        got = ttrain._inpaint_latents(
            tenc, torch.from_numpy(masks), torch.from_numpy(pixels),
            torch.from_numpy(latents), scale, cfg, tdraws)
        _close(got, want, 1e-5, 1e-5)
    assert not np.abs(want[0]).any() and np.abs(want[1]).max() > 0


def test_camera_latents_match_jax(jax_driver, rng):
    """The Plucker video resized to the latent grid (x 6), and the
    first-frame reference channels zeroed where the draw is below 0.2."""
    cfg = dataclasses.replace(JAX_PRESETS["tiny"],
                              add_ref_latent_in_control_model=True)
    cam = rng.standard_normal((3, 6, 5, 16, 16)).astype(np.float32)
    latents = rng.standard_normal((3, 4, 3, 8, 8)).astype(np.float32)
    u = jax.random.uniform(jax.random.PRNGKey(3), (3, 1, 1, 1, 1))
    assert (np.asarray(u) < 0.2).any() and (np.asarray(u) >= 0.2).any()
    for key in (None, jax.random.PRNGKey(3)):
        want = jax_driver._camera_latents(jnp.asarray(cam), jnp.asarray(latents),
                                          None, cfg, key)
        got = ttrain._camera_latents(
            torch.from_numpy(cam), torch.from_numpy(latents), cfg,
            None if key is None else torch.from_numpy(np.array(u).reshape(3)))
        _close(got, want, 1e-5, 1e-5)


# ---------------------------------------------------------------------------
# the driver end to end on the CPU
# ---------------------------------------------------------------------------


def write_media(root, n_images=2, n_videos=2, size=40, frames=20, seed=0):
    """png images and mp4 videos (cv2's encoder) under `root`; returns the
    manifest entries."""
    import cv2
    from PIL import Image

    rng = np.random.RandomState(seed)
    entries = []
    for i in range(n_images):
        name = f"img{i}.png"
        Image.fromarray((rng.rand(size, size, 3) * 255).astype(np.uint8)).save(
            os.path.join(root, name))
        entries.append({"file_path": name, "text": f"image {i}",
                        "type": "image"})
    for i in range(n_videos):
        name = f"vid{i}.mp4"
        w = cv2.VideoWriter(os.path.join(root, name),
                            cv2.VideoWriter_fourcc(*"mp4v"), 4, (size, size))
        for _ in range(frames):
            w.write((rng.rand(size, size, 3) * 255).astype(np.uint8))
        w.release()
        entries.append({"file_path": name, "text": f"video {i}",
                        "type": "video"})
    return entries


def write_pose_file(path, frames=9):
    """A RealEstate10K-style pose file: idx fx fy cx cy k1 k2 + 12 w2c."""
    lines = ["https://example.com/synthetic"]
    for i in range(frames):
        w2c = np.eye(4)[:3].copy()
        w2c[0, 3] = 0.01 * i
        vals = [i, 0.8, 1.2, 0.5, 0.5, 0.0, 0.0] + list(w2c.reshape(-1))
        lines.append(" ".join(str(float(v)) for v in vals))
    with open(path, "w") as f:
        f.write("\n".join(lines))


MODES = {
    "sft": ["--trainable_modules", "attn1", "ff",
            "--trainable_modules_low_learning_rate", "txt_ff",
            "--gradient_accumulation_steps", "2", "--lr_scheduler", "cosine",
            "--lr_warmup_steps", "1", "--use_ema", "--report_model_info",
            "--abnormal_norm", "0", "--validation_steps", "2"],
    "lora": ["--lora_rank", "4"],
    "inpaint": ["--enable_inpaint", "--adaptive_grad_clip",
                "--random_frame_crop", "--validation_steps", "2"],
    "control": ["--train_mode", "control", "--validation_steps", "2"],
    "control_camera_ref": ["--train_mode", "control_camera_ref"],
    "came": ["--optimizer", "came", "--training_with_video_token_length"],
    "adamw8bit": ["--optimizer", "adamw8bit", "--train_batch_size", "2",
                  "--keep_all_node_same_token_length"],
    "ddpm": ["--loss_type", "ddpm", "--uniform_sampling_bands", "2"],
}


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    root = tmp_path_factory.mktemp("media")
    entries = write_media(str(root))
    write_pose_file(str(root / "camera.txt"))
    for e in entries:
        e["control_file_path"] = "vid0.mp4"
        e["camera_file_path"] = "camera.txt"
    (root / "train.json").write_text(json.dumps(entries))
    return root


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tiny_demo_trains_checkpoints_and_resumes(mode, media, tmp_path):
    out = tmp_path / "out"
    base = ["--tiny_demo", "--train_data_meta", str(media / "train.json"),
            "--train_data_dir", str(media), "--output_dir", str(out),
            "--checkpointing_steps", "1", "--dataloader_num_workers", "1",
            "--no-sanity_check"] + MODES[mode]
    run = (ttrain_lora.main if mode == "lora" else ttrain.main)
    first = run(base + ["--max_train_steps", "2"], device="cpu")
    assert first.step0 == 0 and len(first.losses) == 2
    assert all(np.isfinite(first.losses))
    ckpt = out / "checkpoints"
    assert sorted(os.listdir(ckpt)) == ["checkpoint-1", "checkpoint-2"]
    assert json.loads((ckpt / "checkpoint-2" / "sampler.json").read_text()) \
        == first.sampler_state
    second = run(base + ["--max_train_steps", "3", "--resume_from_checkpoint"],
                 device="cpu")
    assert second.step0 == 2 and len(second.losses) == 1
    assert second.state.step == 3 and np.isfinite(second.losses[0])
    assert sorted(os.listdir(ckpt)) == [f"checkpoint-{i}" for i in (1, 2, 3)]
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines
            if "loss" in json.loads(x)] == [0, 1, 2]
    if mode == "lora":
        assert second.lora_path.endswith(
            "lora_diffusion_pytorch_model.safetensors")
        port, _ = ttrain._tiny_models(False, device="cpu")
        lora, cfg = load_lora_reference(port, second.lora_path, device="cpu")
        assert cfg.rank == 4 and set(lora) == set(second.state.params)
        for path, fac in second.state.params.items():
            for kind, t in fac.items():
                assert torch.equal(lora[path][kind], t.detach())
    if mode == "sft":  # the abnormal-step report logged per-parameter norms
        assert any("grad_norm/" in x for x in lines)
    # a 4-step sample rendered with the trained weights after step 2
    assert (out / "validation_2.gif").exists() == ("--validation_steps"
                                                   in MODES[mode])


def test_unported_multi_gpu_flags_raise(media):
    # --fsdp, --distributed and dp / sp meshes are ported
    # (tests/test_torch_parallel_train.py); what is left of item 10 raises
    # before any process group is joined
    base = ["--tiny_demo", "--train_data_meta", str(media / "train.json")]
    for extra in (["--mesh", "dp=1,sp=1,tp=2"],
                  ["--distributed", "--optimizer", "came"],
                  ["--distributed", "--lora_rank", "4"],
                  ["--distributed", "--fsdp", "--lora_rank", "4"],
                  ["--distributed", "--report_model_info"]):
        with pytest.raises(NotImplementedError, match="item 10"):
            ttrain.main(base + extra, device="cpu")
    with pytest.raises(ValueError, match="--distributed"):
        ttrain.main(base + ["--mesh", "dp=2,sp=1,tp=1"], device="cpu")


def test_driver_help_needs_no_jax(tmp_path):
    """`python -m easyanimate_tpu_torch.train --help` in a process where
    jax, flax, easyanimate_tpu, orbax and safetensors cannot be imported."""
    script = textwrap.dedent(f"""
        import runpy, sys
        for name in ("jax", "flax", "easyanimate_tpu", "orbax",
                     "safetensors"):
            sys.modules[name] = None
        sys.path.insert(0, {REPO!r})
        sys.argv = ["train", "--help"]
        try:
            runpy.run_module("easyanimate_tpu_torch.train",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        bad = [m for m in ("jax", "flax", "easyanimate_tpu", "orbax",
                           "safetensors") if sys.modules[m]]
        assert not bad, bad
        print("OK")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, cwd=str(tmp_path), env=env)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), (
        res.stdout[-2000:] + res.stderr[-4000:])
    assert "--train_data_meta" in res.stdout
