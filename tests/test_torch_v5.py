"""Parity of the port's V5 edition with the JAX package: the dual-stream
MMDiT (the Bert stream's text_proj and the mT5 stream's text_proj_t5, each
behind its RMS norm, after_norm in every block), the T2V pipeline under
DDIM and CFG, the inpaint pipeline, cfg_split, TeaCache, the controller,
the SFT and LoRA steps with `text_t5`, and the control pipeline's trap.

One tiny V5 transformer (JAX's tiny preset with text_embed_dim_t5 16,
add_norm_text_encoder and after_norm; XLA attention, whose kernels' parity
is test_torch_attention_grad.py's) is initialised by JAX, perturbed, and
exported to the reference keys, which the port loads with strict=True;
both packages run from those weights in float32 on the CPU, at 64x64x5f
with the tiny MagViT (the port's random weights crossed to JAX), from the
same numpy latents and prompt embeddings. Tolerances are the tiny model's
(5e-4: test_torch_mmdit.py, test_torch_pipeline.py) and the training
steps' (test_torch_training.py).
"""
import dataclasses
import inspect
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.models.mmdit import EasyAnimateTransformer3D as JaxModel
from easyanimate_tpu.models.vae import magvit as jmagvit
from easyanimate_tpu.pipeline import control as jcontrol
from easyanimate_tpu.pipeline import inpaint as jinpaint
from easyanimate_tpu.pipeline import t2v as jt2v
from easyanimate_tpu.pipeline.schedulers import DDIMConfig as JaxDDIM
from easyanimate_tpu.training import lora as jlora
from easyanimate_tpu.training import trainer as jtrainer
from easyanimate_tpu.ui import controller as jcontroller
from easyanimate_tpu_torch import loader
from easyanimate_tpu_torch.models.convert import (export_lora_state_dict,
                                                  load_reference_lora_state_dict,
                                                  load_reference_state_dict,
                                                  mmdit_config_json,
                                                  save_reference_checkpoint)
from easyanimate_tpu_torch.models.mmdit import (PRESETS,
                                                EasyAnimateTransformer3D)
from easyanimate_tpu_torch.pipeline import (DDIMConfig,
                                            EasyAnimateControlPipeline,
                                            EasyAnimateInpaintPipeline,
                                            EasyAnimatePipeline)
from easyanimate_tpu_torch.training import lora as tlora
from easyanimate_tpu_torch.training import trainer as ttrainer
from easyanimate_tpu_torch.ui.controller import EasyAnimateController
from easyanimate_tpu_torch.utils import config as tconfig
from easyanimate_tpu_torch.utils.media import get_image_to_video_latent
from easyanimate_tpu_torch.models.text import TINY_BERT, TINY_T5
from tests.test_torch_mmdit import MODEL_TOL, port_mmdit_cfg
from tests.test_torch_pipeline import LATENT_TOL
from tests.test_torch_safetensors import write_vae_and_scheduler
from tests.test_torch_training import GRAD_TOL, _close, _jax_draws
from tests.test_torch_v5_text import PROMPTS, write_v5_text_dirs
from tests.test_torch_vae import port_vae_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V5_YAML = os.path.join(REPO, "config",
                       "easyanimate_video_v5_magvit_multi_text_encoder.yaml")
# the text widths of the tiny towers (test_torch_v5_text.py), so that a
# directory with both serves end to end
JCFG = dataclasses.replace(JAX_PRESETS["tiny"],
                           text_embed_dim=TINY_BERT.hidden_size,
                           text_embed_dim_t5=TINY_T5.d_model,
                           add_norm_text_encoder=True, after_norm=True,
                           attn_impl="xla")
# the pipelines' size: 32 x 32 x 5 frames on V5_VAE, 3 x 16 x 16 latents
# (the transformer and training tests take 8 x 8 latents, 64 px at the
# full VAE's scale 8)
H = W = 32
FRAMES, STEPS = 5, 3
# the tiny MagViT of examples/train.py's --tiny_demo: one spatial and
# temporal down block, compiled by JAX in a fraction of the 4-block one's
# time
V5_VAE = jmagvit.MagvitVAEConfig(
    latent_channels=4, block_out_channels=(8, 16),
    down_block_types=("SpatialTemporalDownBlock3D", "SpatialDownBlock3D"),
    up_block_types=("SpatialTemporalUpBlock3D", "SpatialUpBlock3D"),
    layers_per_block=1, norm_num_groups=4, mini_batch_encoder=2,
    mini_batch_decoder=1, scaling_factor=0.5)
TEXT, TEXT_T5 = 6, 4


@pytest.fixture(scope="module")
def v5():
    """The tiny V5 transformer: the port's random weights (perturbed, so
    norms and biases are exercised) read by JAX's converter, and JAX's
    export of them to the reference keys, from which the port's model
    loads with strict=True (a JAX init costs seconds). Also the shared
    numpy inputs."""
    from tests.test_torch_serving import _random_weights

    seed_model = EasyAnimateTransformer3D(port_mmdit_cfg(JCFG), device="cpu")
    variables = jconvert.convert_mmdit_state_dict(
        _random_weights(seed_model, 10), JCFG)
    sd = jconvert.export_mmdit_state_dict(variables, JCFG)
    port = EasyAnimateTransformer3D(port_mmdit_cfg(JCFG), device="cpu")
    load_reference_state_dict(port, sd)
    rng = np.random.default_rng(1)
    d, d5 = JCFG.text_embed_dim, JCFG.text_embed_dim_t5
    ins = {"pos": rng.standard_normal((1, TEXT, d)).astype(np.float32),
           "pos_t5": rng.standard_normal((1, TEXT_T5, d5)).astype(np.float32),
           "neg_t5": rng.standard_normal((1, TEXT_T5, d5)).astype(np.float32)}
    ins["neg"] = np.zeros_like(ins["pos"])
    return JaxModel(JCFG), variables, sd, port, ins


def test_v5_transformer_loads_jax_keys_and_matches_jax(v5):
    model, variables, sd, port, ins = v5
    assert {"text_proj.0.weight", "text_proj.1.weight", "text_proj.1.bias",
            "text_proj_t5.0.weight", "text_proj_t5.1.weight",
            "text_proj_t5.1.bias", "transformer_blocks.1.norm3.weight"} <= set(sd)
    assert set(sd) == set(port.state_dict())
    rng = np.random.default_rng(2)
    lat = rng.standard_normal((2, 4, 2, 8, 8)).astype(np.float32)
    t = np.array([3.0, 500.0], np.float32)
    txt = rng.standard_normal((2, 5, JCFG.text_embed_dim)).astype(np.float32)
    t5 = rng.standard_normal((2, 7, JCFG.text_embed_dim_t5)).astype(np.float32)
    rope = jt2v.build_rope(JCFG, 64, 64, 2)
    for with_t5 in (True, False):
        extra = t5 if with_t5 else None
        want = jax.jit(model.apply)(
            variables, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(txt),
            rope, encoder_hidden_states_t5=(None if extra is None
                                            else jnp.asarray(extra)))
        with torch.no_grad():
            got = port(torch.from_numpy(lat), torch.from_numpy(t),
                       torch.from_numpy(txt),
                       tuple(torch.from_numpy(np.array(r)) for r in rope),
                       encoder_hidden_states_t5=(None if extra is None else
                                                 torch.from_numpy(extra)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=MODEL_TOL, rtol=MODEL_TOL)
        if with_t5:
            with_stream = got
    assert (with_stream - got).abs().max() > 1e-3  # the stream is read
    # the [text, t5] join: 5 + 7 text tokens in front of the blocks
    _, tok, _ = port.embed(torch.from_numpy(lat), torch.from_numpy(t),
                           torch.from_numpy(txt),
                           encoder_hidden_states_t5=torch.from_numpy(t5))
    assert tok.shape == (2, 12, JCFG.inner_dim)


@pytest.fixture(scope="module")
def vae_pair():
    """V5_VAE in both packages: the port's random weights, read by JAX's
    converter."""
    from tests.test_torch_serving import _random_weights

    vae = loader.AutoencoderKLMagvit(port_vae_cfg(V5_VAE), device="cpu")
    vparams = jconvert.convert_vae_state_dict(_random_weights(vae, 0), V5_VAE)
    return jmagvit.AutoencoderKLMagvit(V5_VAE), vparams, vae


_PIPES = {}


def pipes(kind, v5, vae_pair):
    """(JAX pipeline, port pipeline) on the V5 weights under DDIM."""
    if kind not in _PIPES:
        model, variables, _, port, _ = v5
        jvae, vparams, vae = vae_pair
        jcls, cls = {"t2v": (jt2v.EasyAnimatePipeline, EasyAnimatePipeline),
                     "inpaint": (jinpaint.EasyAnimateInpaintPipeline,
                                 EasyAnimateInpaintPipeline)}[kind]
        _PIPES[kind] = (jcls(transformer=model, vae=jvae,
                             transformer_params=variables, vae_params=vparams,
                             scheduler=JaxDDIM()),
                        cls(port, vae, "cpu", scheduler=DDIMConfig()))
    return _PIPES[kind]


def _port(pipe, ins, lat0, **kw):
    return pipe(torch.from_numpy(ins["pos"]), torch.from_numpy(ins["neg"]),
                prompt_embeds_t5=torch.from_numpy(ins["pos_t5"]),
                negative_prompt_embeds_t5=torch.from_numpy(ins["neg_t5"]),
                latents=torch.from_numpy(lat0), height=H, width=W,
                video_length=FRAMES, num_inference_steps=STEPS,
                guidance_scale=6.0, output_type="latent", **kw)


def _run(jpipe, pipe, ins, lat0, jkw=None, tkw=None, **kw):
    """Final latents of JAX's pipeline (numpy) and the port's (a tensor)
    on both streams under CFG 6."""
    lat_j = np.asarray(jpipe(
        jnp.asarray(ins["pos"]), jnp.asarray(ins["neg"]),
        prompt_embeds_t5=jnp.asarray(ins["pos_t5"]),
        negative_prompt_embeds_t5=jnp.asarray(ins["neg_t5"]), height=H,
        width=W, video_length=FRAMES, num_inference_steps=STEPS,
        guidance_scale=6.0, output_type="latent", **kw, **(jkw or {})))
    return lat_j, _port(pipe, ins, lat0, **kw, **(tkw or {}))


def test_t2v_ddim_cfg_matches_jax_and_cfg_split_matches_batched(v5, vae_pair):
    """Both streams under CFG 6 with DDIM; cfg_split's halves, and
    cfg_skip_ratio's cond-only tail, carry the T5 stream as they carry the
    text."""
    jpipe, pipe = pipes("t2v", v5, vae_pair)
    ins = v5[4]
    lat0 = np.random.default_rng(3).standard_normal(
        pipe.latent_shape(1, FRAMES, H, W)).astype(np.float32)
    jkw = {"latents": jnp.asarray(lat0)}
    lat_j, lat_t = _run(jpipe, pipe, ins, lat0, jkw)
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=LATENT_TOL,
                               rtol=LATENT_TOL)
    # the halves one after the other: the same sums but for the CPU BLAS's
    # blocking by batch (1.1e-5 here; bit-equal on the card, chip_smoke.py
    # serve)
    split = _port(pipe, ins, lat0, cfg_split=True)
    np.testing.assert_allclose(split.numpy(), lat_t.numpy(), atol=LATENT_TOL,
                               rtol=LATENT_TOL)
    lat_j, lat_t = _run(jpipe, pipe, ins, lat0, jkw, cfg_skip_ratio=0.34)
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=LATENT_TOL,
                               rtol=LATENT_TOL)
    # without the negative T5 stream CFG has nothing to batch
    with pytest.raises(ValueError, match="negative"):
        pipe(torch.from_numpy(ins["pos"]), torch.from_numpy(ins["neg"]),
             prompt_embeds_t5=torch.from_numpy(ins["pos_t5"]), height=H,
             width=W, video_length=FRAMES, num_inference_steps=1,
             output_type="latent")


def test_teacache_matches_jax(v5, vae_pair, monkeypatch):
    """TeaCache's embed carries the T5 stream: at 1e9 every step but the
    first and last reuses the residual, in both packages alike."""
    jpipe, pipe = pipes("t2v", v5, vae_pair)
    pipe.teacache_coefficients = jt2v.TEACACHE_COEFFICIENTS
    lat0 = np.random.default_rng(4).standard_normal(
        pipe.latent_shape(1, FRAMES, H, W)).astype(np.float32)
    lat_j, lat_t = _run(jpipe, pipe, v5[4], lat0,
                        {"latents": jnp.asarray(lat0)},
                        teacache_threshold=1e9)
    assert pipe.last_teacache_skips == STEPS - 2
    assert int(jpipe.last_teacache_skips) == STEPS - 2
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=LATENT_TOL,
                               rtol=LATENT_TOL)


def test_inpaint_matches_jax(v5, vae_pair):
    """I2V from a random start frame with both streams; JAX's noise is its
    draw from its key, handed to the port."""
    jpipe, pipe = pipes("inpaint", v5, vae_pair)
    shape = pipe.latent_shape(1, FRAMES, H, W)
    key = jax.random.PRNGKey(5)
    lat0 = np.array(jax.random.normal(jax.random.split(key)[0], shape,
                                      jnp.float32))
    image = np.random.default_rng(5).integers(0, 256, (H, W, 3),
                                              dtype=np.uint8)
    video, mask = get_image_to_video_latent(image, None, FRAMES, (H, W))
    lat_j, lat_t = _run(
        jpipe, pipe, v5[4], lat0,
        {"rng": key, "video": jnp.asarray(video),
         "mask_video": jnp.asarray(mask)},
        {"video": video, "mask_video": mask}, noise_aug_strength=0.0)
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=LATENT_TOL,
                               rtol=LATENT_TOL)


def test_controller_hands_the_t5_stream_to_the_pipeline(v5, vae_pair):
    """A load_text_encoders-style dict encoder: the controller returns the
    T5 stream as pipeline keywords, as JAX's _embeds does, and a request
    equals the pipeline's own call with them."""
    _, pipe = pipes("t2v", v5, vae_pair)
    ins = v5[4]

    def encode(prompts):
        src = ("pos", "pos_t5") if prompts[0] else ("neg", "neg_t5")
        return {"text": torch.from_numpy(ins[src[0]]),
                "text_t5": torch.from_numpy(ins[src[1]])}

    def jencode(prompts):
        return {k: jnp.asarray(v.numpy()) for k, v in encode(prompts).items()}

    ctl = EasyAnimateController(pipeline=pipe, encode_text=encode)
    pos, neg, extra = ctl._embeds("a prompt", "")
    jpos, jneg, jextra = jcontroller.EasyAnimateController(
        pipeline=None, encode_text=jencode)._embeds("a prompt", "")
    assert set(extra) == set(jextra) == {"prompt_embeds_t5",
                                         "negative_prompt_embeds_t5"}
    for got, want in ((pos, jpos), (neg, jneg),
                      *((extra[k], jextra[k]) for k in extra)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = ctl.generate(prompt="a prompt", sample_steps=2, width=W, height=H,
                       video_length=FRAMES, cfg_scale=6.0, seed=3,
                       output_type="latent")
    want = pipe(pos, neg, height=H, width=W, video_length=FRAMES,
                num_inference_steps=2, guidance_scale=6.0,
                output_type="latent",
                generator=torch.Generator().manual_seed(3), **extra)
    assert torch.equal(got, want)


def _train_batches(ins, seed=6):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((1, 4, 2, 8, 8)).astype(np.float32)
    cos, sin = jt2v.build_rope(JCFG, 64, 64, 2)
    arrays = {"latents": lat, "text": ins["pos"], "text_t5": ins["pos_t5"]}
    jbatch = {k: jnp.asarray(v) for k, v in arrays.items()}
    jbatch["rope"] = (cos, sin)
    tbatch = {k: torch.from_numpy(v) for k, v in arrays.items()}
    tbatch["rope"] = (torch.from_numpy(np.array(cos)),
                      torch.from_numpy(np.array(sin)))
    return jbatch, tbatch


@pytest.mark.parametrize("kind", ["sft", "lora"])
def test_training_steps_with_text_t5_match_jax(v5, kind):
    """One make_train_step / make_lora_train_step step on a batch with
    text_t5, from the same draws: loss, grad norm and the updated
    parameters (SFT: every tensor, text_proj_t5's included) or factors."""
    model, variables, _, port, ins = v5
    jbatch, tbatch = _train_batches(ins)
    key = jax.random.PRNGKey(7)
    kw = dict(learning_rate=2e-5)
    jcfg_t, tcfg = jtrainer.TrainConfig(**kw), ttrainer.TrainConfig(**kw)
    draws = _jax_draws(key, jbatch["latents"], jcfg_t.loss)
    base = {n: p.clone() for n, p in port.state_dict().items()}
    try:
        if kind == "sft":
            jstate, jm = jax.jit(jtrainer.make_train_step(model, jcfg_t))(
                jtrainer.create_train_state(variables, jcfg_t), jbatch, key)
            tstate, tm = ttrainer.make_train_step(port, tcfg)(
                ttrainer.create_train_state(port, tcfg), tbatch, draws=draws)
            want = jconvert.export_mmdit_state_dict(jstate.params, JCFG)
            got = tstate.params
        else:
            jlcfg, tlcfg = jlora.LoRAConfig(rank=4), tlora.LoRAConfig(rank=4)
            jinit, jstep = jlora.make_lora_train_step(model, jcfg_t, jlcfg,
                                                      variables)
            jstep = jax.jit(jstep)
            jstate = jinit(jax.random.PRNGKey(8))
            jstate = jstate.replace(params={
                p: {"down": f["down"], "up": 0.01 * jax.random.normal(
                    jax.random.PRNGKey(i), f["up"].shape)}
                for i, (p, f) in enumerate(sorted(jstate.params.items()))})
            lora, _ = load_reference_lora_state_dict(
                port, jconvert.export_lora_state_dict(jstate.params,
                                                      jlcfg.alpha, JCFG),
                device="cpu")
            tinit, tstep = tlora.make_lora_train_step(port, tcfg, tlcfg)
            jstate, jm = jstep(jstate, jbatch, key)
            tstate, tm = tstep(tinit(lora=lora), tbatch, draws=draws)
            want = jconvert.export_lora_state_dict(jstate.params, jlcfg.alpha,
                                                   JCFG)
            got = export_lora_state_dict(tstate.params, tlcfg.alpha)
        _close(tm["loss"], jm["loss"], GRAD_TOL)
        _close(tm["grad_norm"], jm["grad_norm"], GRAD_TOL)
        assert set(got) == set(want)
        for name, w in want.items():
            _close(got[name], w, 0, atol=2 * kw["learning_rate"])
    finally:  # the module's other tests share the port's weights
        port.load_state_dict(base)
        port.requires_grad_(True)


def test_trap_control_takes_no_t5_stream(v5, vae_pair):
    """JAX's control pipeline has no T5 parameter and swallows one in its
    **kw, so a V5 control request runs on the Bert stream alone; the
    port's takes the T5 keywords and leaves them unused, alike."""
    jparams = inspect.signature(jcontrol.EasyAnimateControlPipeline.__call__
                                ).parameters
    assert "prompt_embeds_t5" not in jparams
    assert any(p.kind is p.VAR_KEYWORD for p in jparams.values())
    _, variables, sd, _, ins = v5
    cfg = dataclasses.replace(port_mmdit_cfg(JCFG), in_channels=8)
    port = EasyAnimateTransformer3D(cfg, device="cpu")
    gen = torch.Generator().manual_seed(9)
    proj = torch.randn(cfg.inner_dim, 8, 2, 2, generator=gen) * 0.1
    load_reference_state_dict(port, {**sd, "proj.weight": proj.numpy()})
    pipe = EasyAnimateControlPipeline(port, vae_pair[2], "cpu")
    lat0 = torch.from_numpy(np.random.default_rng(9).standard_normal(
        pipe.latent_shape(1, FRAMES, H, W)).astype(np.float32))
    kw = dict(height=H, width=W, video_length=FRAMES, num_inference_steps=2,
              guidance_scale=6.0, output_type="latent", latents=lat0)
    args = (torch.from_numpy(ins["pos"]), torch.from_numpy(ins["neg"]))
    plain = pipe(*args, **kw)
    with_t5 = pipe(*args, prompt_embeds_t5=torch.from_numpy(ins["pos_t5"]),
                   negative_prompt_embeds_t5=torch.from_numpy(ins["neg_t5"]),
                   **kw)
    assert torch.equal(plain, with_t5)


def test_v5_yaml_and_a_port_written_directory_build_the_port(v5, vae_pair,
                                                            tmp_path):
    """utils.config builds the V5 MMDiT from the repository's V5 yaml (the
    12B's widths: PRESETS["v5-12b"]); load_pipeline reads a V5 directory
    the port wrote (JAX's exported transformer keys, the tiny MagViT, a
    DDIM scheduler_config.json, the Bert and mT5 towers) strictly, and a
    controller on load_text_encoders serves it as the pipeline serves the
    encoders' embeddings."""
    pytest.importorskip("yaml")
    model, cfg = tconfig.build_transformer(
        tconfig.load_yaml_config(V5_YAML), device="meta",
        num_attention_heads=48, num_layers=48)
    assert cfg == PRESETS["v5-12b"]
    assert dataclasses.replace(PRESETS["v5.1-12b"], text_embed_dim=1024,
                               text_embed_dim_t5=2048,
                               add_norm_text_encoder=True,
                               after_norm=True) == cfg
    assert model.text_proj_t5[1].weight.shape == (3072, 2048)

    _, _, sd, port, _ = v5
    save_reference_checkpoint(str(tmp_path / "transformer"), sd,
                              mmdit_config_json(port.cfg),
                              max_shard_bytes=100_000)
    vae = vae_pair[2]
    write_vae_and_scheduler(str(tmp_path), vae.cfg, vae.state_dict())
    (tmp_path / "scheduler" / "scheduler_config.json").write_text(
        json.dumps({"_class_name": "DDIMScheduler",
                    "num_train_timesteps": 1000}))
    write_v5_text_dirs(tmp_path)
    pipe = loader.load_pipeline(str(tmp_path), dtype="float32", device="cpu")
    assert pipe.transformer.cfg == port.cfg
    assert pipe.scheduler == DDIMConfig()
    for k, v in pipe.transformer.state_dict().items():
        assert torch.equal(v, torch.from_numpy(np.asarray(sd[k]))), k
    encode = loader.load_text_encoders(str(tmp_path), max_length=12,
                                       device="cpu")
    ctl = EasyAnimateController(pipeline=pipe, encode_text=encode)
    kw = dict(width=W, height=H, video_length=FRAMES, seed=2,
              output_type="latent")
    got = ctl.generate(prompt=PROMPTS[0], negative_prompt=PROMPTS[1],
                       sample_steps=2, cfg_scale=6.0, **kw)
    pos, neg = encode([PROMPTS[0]]), encode([PROMPTS[1]])
    want = pipe(pos["text"], neg["text"], prompt_embeds_t5=pos["text_t5"],
                negative_prompt_embeds_t5=neg["text_t5"], height=H, width=W,
                video_length=FRAMES, num_inference_steps=2,
                guidance_scale=6.0, output_type="latent",
                generator=torch.Generator().manual_seed(2))
    assert torch.equal(got, want) and torch.isfinite(got).all()
