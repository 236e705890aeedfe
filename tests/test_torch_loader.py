"""Parity of the port's loader (easyanimate_tpu_torch/loader.py), its
config mappers and yaml builders, fp8 weight storage and the kohya LoRA
file with the JAX package.

One tiny reference-layout model directory is written once per module by
the JAX package's own writer (save_reference_checkpoint +
_mmdit_config_json, sharded by a small max_shard_bytes, as
tests/test_convert.py::_write_tiny_model_dir does, from its synthetic
state dicts); both packages' load_pipeline read it in float32 on the CPU and denoise 2 CFG steps from
the same noise and embeddings. Latents agree to 5e-4, the bound of
tests/test_torch_pipeline.py; with fp8 weights the fp8 bytes are equal.
"""
import dataclasses
import json
import os

import flax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu import loader as jloader
from easyanimate_tpu.models import convert as jconvert
from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.utils import config as jconfig
from easyanimate_tpu_torch import loader
from easyanimate_tpu_torch.models import convert as tconvert
from easyanimate_tpu_torch.models.mmdit import PRESETS, EasyAnimateTransformer3D
from easyanimate_tpu_torch.models.vae import MagvitVAEConfig
from easyanimate_tpu_torch.ops import quant as tquant
from easyanimate_tpu_torch.training import lora as tlora
from easyanimate_tpu_torch.utils import config as tconfig
from easyanimate_tpu_torch.utils.fp8 import FP8, fp8_byte_share
from easyanimate_tpu_torch.utils.safetensors_io import (load_dir, load_file,
                                                       save_file)
from tests.test_convert import TINY_VAE as JAX_TINY_VAE
from tests.test_convert import _synth_mmdit_sd, _synth_vae_sd
from tests.test_torch_pipeline import LATENT_TOL
from tests.test_torch_safetensors import (write_tiny_model_dir,
                                          write_vae_and_scheduler)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "config", "easyanimate_video_v5.1_magvit_qwen.yaml")
H = W = 32
FRAMES, STEPS = 5, 2


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The JAX-written directory: a 6-head tiny MMDiT with one dense and one
    SWA layer (3 shards + index), TINY_VAE, a FlowMatch scheduler."""
    root = str(tmp_path_factory.mktemp("jax_model"))
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], num_attention_heads=6,
                               swa_layers=(1,))
    rng = np.random.default_rng(0)
    sd = {k: 0.05 * v for k, v in _synth_mmdit_sd(jcfg, rng).items()}
    names = jconvert.save_reference_checkpoint(
        os.path.join(root, "transformer"), sd, jconvert._mmdit_config_json(jcfg),
        max_shard_bytes=60_000)
    assert len(names) > 1
    write_vae_and_scheduler(root, JAX_TINY_VAE,
                            _synth_vae_sd(JAX_TINY_VAE, rng))
    inputs = dict(
        lat0=rng.standard_normal((1, 4, 3, H // 2, W // 2)).astype(np.float32),
        pos=rng.standard_normal((1, 6, jcfg.text_embed_dim)).astype(np.float32))
    return root, jcfg, sd, inputs


def _run_both(root, inputs, **kw):
    """(JAX pipeline, port pipeline, JAX latents, port latents) after STEPS
    CFG steps from the same noise and embeddings."""
    jpipe = jloader.load_pipeline(root, "t2v", dtype="float32", **kw)
    pipe = loader.load_pipeline(root, dtype="float32", device="cpu", **kw)
    pos, lat0 = inputs["pos"], inputs["lat0"]
    args = dict(height=H, width=W, video_length=FRAMES,
                num_inference_steps=STEPS, guidance_scale=6.0,
                output_type="latent")
    lat_j = np.asarray(jpipe(jnp.asarray(pos), jnp.zeros_like(jnp.asarray(pos)),
                             latents=jnp.asarray(lat0), **args))
    lat_t = pipe(torch.from_numpy(pos), torch.zeros(pos.shape),
                 latents=torch.from_numpy(lat0), **args).numpy()
    return jpipe, pipe, lat_j, lat_t


def test_load_pipeline_matches_jax(model_dir):
    root, jcfg, sd, inputs = model_dir
    _, pipe, lat_j, lat_t = _run_both(root, inputs)
    assert lat_t.shape == lat_j.shape == inputs["lat0"].shape
    assert not np.array_equal(lat_t, inputs["lat0"])
    np.testing.assert_allclose(lat_t, lat_j, atol=LATENT_TOL, rtol=LATENT_TOL)
    # the loaded tensors are the file's, float32, on the CPU
    got = pipe.transformer.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert torch.equal(got[k], torch.from_numpy(v)), k
    assert pipe.device == torch.device("cpu")
    assert pipe.scheduler == loader.FlowMatchEulerConfig(shift=3.0)


def test_fp8_weights_match_jax_bit_for_bit(model_dir):
    root, jcfg, sd, inputs = model_dir
    jpipe, pipe, lat_j, lat_t = _run_both(root, inputs, fp8_weights=True)
    assert np.isfinite(lat_t).all()
    np.testing.assert_allclose(lat_t, lat_j, atol=LATENT_TOL, rtol=LATENT_TOL)
    want = jconvert.export_mmdit_state_dict(jpipe.transformer_params, jcfg)
    got = pipe.transformer.state_dict()
    assert set(got) == set(want)
    n_fp8 = 0
    for k, v in got.items():
        if v.dim() >= 2:
            assert v.dtype == FP8 and want[k].dtype.itemsize == 1, k
            np.testing.assert_array_equal(v.view(torch.uint8).numpy(),
                                          want[k].view(np.uint8), err_msg=k)
            n_fp8 += 1
        else:  # norms and biases keep float32, as JAX keeps them
            assert v.dtype == torch.float32, k
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert n_fp8 > 0 and 0.5 < fp8_byte_share(pipe.transformer) < 1.0


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("kw,mode", [
    ({"int8_linears": True}, "int8"),
    ({"int4_weights": True, "int4_compute": "int8"}, "w4a8"),
    ({"int4_weights": True, "int4_compute": "bf16"}, "int4")])
def test_quantized_loads_match_jax(model_dir, kw, mode, fp8):
    """int8_linears and int4_weights (W4A8 and W4A16), each alone and with
    fp8_weights, against JAX's load of the same directory: the latents
    after STEPS steps; the block linears quantized from the file's weights
    exactly as quantize_module_*_ quantizes them; fp8 only outside them."""
    root, jcfg, sd, inputs = model_dir
    _, pipe, lat_j, lat_t = _run_both(root, inputs, fp8_weights=fp8, **kw)
    assert not np.array_equal(lat_t, inputs["lat0"])
    np.testing.assert_allclose(lat_t, lat_j, atol=LATENT_TOL, rtol=LATENT_TOL)
    model = pipe.transformer
    assert model.cfg.linear_quant == mode
    quantized = {p: m for p, m in model.named_modules()
                 if isinstance(m, tquant.QuantLinear)}
    assert len(quantized) == 2 * 12 and {m.mode for m in quantized.values()} \
        == {mode}
    for path, mod in quantized.items():
        w = torch.from_numpy(sd[path + ".weight"])
        q, s = (tquant.quantize_weight_int8(w) if mode == "int8"
                else tquant.quantize_weight_int4(w))
        assert torch.equal(mod.weight, q) and torch.equal(mod.scale, s), path
        assert mod.bias.dtype == torch.float32
    assert (0.0 < fp8_byte_share(model) < 1.0) == fp8
    assert all(p.dtype != FP8 for m in quantized.values()
               for p in m.parameters())


def test_transformer_path_overlays_one_tensor(model_dir, tmp_path, capsys):
    root, _, sd, _ = model_dir
    key = "transformer_blocks.0.attn1.to_q.weight"
    path = str(tmp_path / "override.safetensors")
    save_file({key: 2.0 * sd[key], "not_in_the_model.weight": sd[key]}, path)
    base = loader.load_pipeline(root, dtype="float32", device="cpu")
    over = loader.load_pipeline(root, dtype="float32", device="cpu",
                                transformer_path=path)
    assert "unexpected keys: 1" in capsys.readouterr().out
    b, o = base.transformer.state_dict(), over.transformer.state_dict()
    changed = [k for k in b if not torch.equal(b[k], o[k])]
    assert changed == [key]
    assert torch.equal(o[key], 2.0 * b[key])
    with pytest.raises(ValueError, match="safetensors"):
        loader.load_pipeline(root, dtype="float32", device="cpu",
                             transformer_path=str(tmp_path / "x.bin"))


def _shared_fields(port_cfg, jax_cfg):
    names = ({f.name for f in dataclasses.fields(port_cfg)}
             & {f.name for f in dataclasses.fields(jax_cfg)})
    assert len(names) > 10
    for n in sorted(names):
        assert getattr(port_cfg, n) == getattr(jax_cfg, n), n


def test_config_mappers_and_yaml_builders_match_jax(model_dir):
    root = model_dir[0]
    for sub, port_fn, jax_fn in (
            ("transformer", loader.mmdit_config_from_json,
             jloader.mmdit_config_from_json),
            ("vae", loader.vae_config_from_json,
             jloader.vae_config_from_json)):
        with open(os.path.join(root, sub, "config.json")) as f:
            cfg_json = json.load(f)
        for dtype in ("float32", "bfloat16"):
            _shared_fields(port_fn(cfg_json, dtype), jax_fn(cfg_json, dtype))
    # the reference's V5.1 12B config.json fields, and the defaults
    v51 = {"num_layers": 48, "swa_layers": None, "text_embed_dim": 3584,
           "ref_channels": 16, "clip_channels": 1280,
           "add_ref_latent_in_control_model": True}
    for cfg_json in (v51, {}):
        _shared_fields(loader.mmdit_config_from_json(cfg_json),
                       jloader.mmdit_config_from_json(cfg_json))
    vae_json = {"cache_mag_vae": True, "down_block_types":
                "('SpatialDownBlock3D', 'SpatialTemporalDownBlock3D', "
                "'SpatialTemporalDownBlock3D', 'SpatialTemporalDownBlock3D')",
                "up_block_types": list(MagvitVAEConfig.up_block_types)}
    _shared_fields(loader.vae_config_from_json(vae_json),
                   jloader.vae_config_from_json(vae_json))
    # without up_block_types JAX takes the down names (which its decoder
    # rejects); the port takes the up names
    del vae_json["up_block_types"]
    assert (loader.vae_config_from_json(vae_json).up_block_types
            == MagvitVAEConfig.up_block_types)

    yaml_cfg = tconfig.load_yaml_config(YAML)
    assert yaml_cfg == jconfig.load_yaml_config(YAML)
    model, cfg = tconfig.build_transformer(yaml_cfg, device="meta")
    _, jcfg = jconfig.build_transformer(yaml_cfg)
    _shared_fields(cfg, jcfg)
    assert cfg.add_ref_latent_in_control_model and hasattr(model, "ref_proj")
    vae, vcfg = tconfig.build_vae(yaml_cfg, device="meta")
    _, jvcfg = jconfig.build_vae(yaml_cfg)
    _shared_fields(vcfg, jvcfg)
    flags = {"vae_kwargs": {"vae_type": "AutoencoderKLMagvit",
                            "cache_mag_vae": True, "mini_batch_encoder": 2}}
    _shared_fields(tconfig.build_vae(flags, device="meta")[1],
                   jconfig.build_vae(flags)[1])


def test_ref_and_clip_parameters_load_strictly_and_their_inputs_raise():
    """A V5.1 checkpoint that carries ref_proj / clip_proj loads with
    strict=True (JAX convert.py:118-119 keys); their inputs, which raised
    before the control path was ported, now change the forward
    (tests/test_torch_control.py holds them against JAX)."""
    cfg = dataclasses.replace(PRESETS["tiny"], ref_channels=4, clip_channels=8)
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], ref_channels=4,
                               clip_channels=8)
    model = EasyAnimateTransformer3D(cfg, device="cpu")
    assert model.ref_proj.weight.shape == (cfg.inner_dim, 4, 2, 2)
    assert model.clip_proj.weight.shape == (cfg.inner_dim, 8)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    variables = jconvert.convert_mmdit_state_dict(sd, jcfg)
    flat = flax.traverse_util.flatten_dict(variables["params"], sep="/")
    assert {"ref_proj/proj/kernel", "clip_proj/kernel"} <= set(flat)
    tconvert.load_reference_state_dict(model, sd)
    lat = torch.zeros(1, 4, 2, 8, 8)
    args = (lat, torch.ones(1), torch.zeros(1, 3, cfg.text_embed_dim))
    with torch.no_grad():
        plain = model(*args)  # no ref / clip inputs: the plain T2V forward
        for kw in ({"ref_latents": torch.ones(1, 4, 1, 8, 8)},
                   {"clip_encoder_hidden_states": torch.ones(1, 3, 8)}):
            out = model(*args, **kw)
            assert out.shape == plain.shape and torch.isfinite(out).all()
            assert (out - plain).abs().max() > 1e-4


def test_everything_not_ported_raises(model_dir, tmp_path):
    root = model_dir[0]

    def load(**kw):
        return loader.load_pipeline(root, dtype="float32", device="cpu", **kw)

    with pytest.raises(ValueError, match="exclusive"):
        load(int8_linears=True, int4_weights=True)
    with pytest.raises(ValueError, match="int4_compute must be int8|bf16"):
        load(int4_weights=True, int4_compute="fp8")
    # the quantized linears are ported: they load (test_quantized_loads_
    # match_jax holds them against JAX)
    for kw, mode in (({"int8_linears": True}, "int8"),
                     ({"int4_weights": True}, "w4a8"),
                     ({"int4_weights": True, "int4_compute": "bf16"}, "int4")):
        assert load(**kw).transformer.cfg.linear_quant == mode
    # the control pipeline and the samplers are ported: they load
    assert isinstance(load(pipeline_type="control"),
                      loader.EasyAnimateControlPipeline)
    assert isinstance(load(scheduler="ddim").scheduler, loader.DDIMConfig)
    # any other scheduler string gives FlowMatch's defaults, as in JAX
    assert load(scheduler="euler").scheduler == loader.FlowMatchEulerConfig()
    # no FlowMatch scheduler config: JAX falls back to DDIM
    assert loader._scheduler(str(tmp_path), None) == loader.DDIMConfig()
    assert isinstance(load(pipeline_type="inpaint"),
                      loader.EasyAnimateInpaintPipeline)
    for vae_json in ({}, {"slice_mag_vae": True}):  # JAX: "none", "slice_mag"
        with pytest.raises(NotImplementedError, match="item 8"):
            loader.vae_config_from_json(vae_json)
    # V5's two text-stream fields are ported: they reach the config (and
    # the model's text_proj_t5 and pre-norms, tests/test_torch_v5.py)
    v5 = loader.mmdit_config_from_json({"text_embed_dim": 1024,
                                        "text_embed_dim_t5": 2048,
                                        "add_norm_text_encoder": True,
                                        "after_norm": True})
    assert (v5.text_embed_dim, v5.text_embed_dim_t5, v5.add_norm_text_encoder,
            v5.after_norm) == (1024, 2048, True, True)
    assert loader.mmdit_config_from_json(
        {"add_norm_text_encoder": True}).text_embed_dim_t5 is None
    with pytest.raises(NotImplementedError, match="item 11"):
        loader.mmdit_config_from_json(
            {"time_position_encoding_type": "2d_rope"})
    for t_type in ("HunyuanTransformer3DModel", "Transformer3DModel"):
        with pytest.raises(NotImplementedError, match="item 11"):
            tconfig.build_transformer({"transformer_type": t_type})
    for v_type in ("AutoencoderKL", "AutoencoderKLCogVideoX"):
        with pytest.raises(NotImplementedError, match="item 11"):
            tconfig.build_vae({"vae_type": v_type})
    with pytest.raises(NotImplementedError, match="item 8"):
        tconfig.build_vae({"chunk_mode": "slice_mag"})
    # the Bert / T5 stacks are ported (tests/test_torch_v5_text.py loads
    # them): a Bert directory needs its mT5 text_encoder_2, and each tower
    # needs its weights
    te = tmp_path / "text_encoder"
    te.mkdir()
    for model_type, missing in (("bert", "text_encoder_2"),
                                ("t5", "safetensors"), ("mt5", "safetensors")):
        (te / "config.json").write_text(json.dumps({"model_type": model_type}))
        with pytest.raises(FileNotFoundError, match=missing):
            loader.load_text_encoders(str(tmp_path), device="cpu")


def test_strictness(model_dir, tmp_path):
    """A missing tensor always raises; an extra one raises unless
    strict=False, which drops it."""
    root = model_dir[0]
    copy = tmp_path / "m"
    copy.mkdir()
    for sub in ("vae", "scheduler"):
        os.symlink(os.path.join(root, sub), copy / sub)
    sd = {k: v.numpy()
          for k, v in load_dir(os.path.join(root, "transformer")).items()}
    tdir = str(copy / "transformer")
    with open(os.path.join(root, "transformer", "config.json")) as f:
        cfg_json = json.load(f)
    extra = dict(sd, **{"extra.weight": np.zeros(3, np.float32)})
    tconvert.save_reference_checkpoint(tdir, extra, cfg_json)
    with pytest.raises(RuntimeError, match="extra.weight"):
        loader.load_pipeline(str(copy), dtype="float32", device="cpu")
    pipe = loader.load_pipeline(str(copy), dtype="float32", device="cpu",
                                strict=False)
    assert "extra.weight" not in pipe.transformer.state_dict()
    missing = {k: v for k, v in sd.items() if k != "proj_out.bias"}
    os.remove(os.path.join(tdir, "diffusion_pytorch_model.safetensors"))
    tconvert.save_reference_checkpoint(tdir, missing, cfg_json)
    for strict in (True, False):
        with pytest.raises(RuntimeError, match="proj_out.bias"):
            loader.load_pipeline(str(copy), dtype="float32", device="cpu",
                                 strict=strict)


def test_port_written_directory_loads_in_jax(tmp_path):
    root = str(tmp_path / "port_model")
    model, vae = write_tiny_model_dir(root)
    jpipe = jloader.load_pipeline(root, "t2v", dtype="float32")
    jcfg = jloader.mmdit_config_from_json(
        json.load(open(os.path.join(root, "transformer", "config.json"))),
        "float32")
    back = jconvert.export_mmdit_state_dict(jpipe.transformer_params, jcfg)
    want = model.state_dict()
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v.numpy(), err_msg=k)
    vback = jconvert.export_vae_state_dict(
        jpipe.vae_params, jloader.vae_config_from_json(json.load(open(
            os.path.join(root, "vae", "config.json"))), "float32"))
    assert set(vback) == set(vae.state_dict())


def test_kohya_lora_file_crosses_both_ways(tmp_path):
    """The port's kohya file -> JAX convert_lora_state_dict -> JAX's
    save_lora_reference -> the port's load_lora_reference: exact."""
    cfg, jcfg = PRESETS["tiny"], JAX_PRESETS["tiny"]
    model = EasyAnimateTransformer3D(cfg, device="cpu")
    lora = tlora.lora_init(model, tlora.LoRAConfig(rank=4),
                           torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    for f in lora.values():
        f["up"].normal_(0.0, 0.1, generator=gen)
    path = str(tmp_path / "lora.safetensors")
    tconvert.save_lora_reference(path, lora, 8.0)
    jl, jlcfg = jconvert.convert_lora_state_dict(jconvert.load_safetensors(path),
                                                 jcfg)
    assert (jlcfg.rank, jlcfg.alpha) == (4, 8.0)
    path2 = str(tmp_path / "jax_lora.safetensors")
    jconvert.save_lora_reference(path2, jl, jlcfg.alpha, jcfg)
    back, lcfg = tconvert.load_lora_reference(model, path2, device="cpu")
    assert (lcfg.rank, lcfg.alpha) == (4, 8.0) and set(back) == set(lora)
    for p, f in lora.items():
        for kind in ("down", "up"):
            assert torch.equal(back[p][kind], f[kind]), (p, kind)
    assert set(load_file(path)) == set(load_file(path2))
