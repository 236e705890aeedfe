"""Parity of the port's quantized block linears (easyanimate_tpu_torch/
ops/quant.py: W8A8 int8, W4A16 and W4A8 packed int4) with the JAX package's
ops/quant.py, and the code that routes the MMDiT through them: the loader's
modes, the LoRA merge into quantized weights, the export refusal, the
carrier from JAX's quantized trees and the controller's swap.

Each case feeds the same numpy inputs, made from a seed, to both packages,
on the CPU (the port takes the kernels' plain versions there; JAX's model
runs its attention through the XLA reference). JAX's side of a model is
built from the port's random float weights through JAX's converter.
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
from easyanimate_tpu.ops import quant as jquant
from easyanimate_tpu.training import lora as jlora
from easyanimate_tpu_torch.loader import load_pipeline
from easyanimate_tpu_torch.models import convert as tconvert
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.ops import quant as tquant
from easyanimate_tpu_torch.training import lora as tlora
from easyanimate_tpu_torch.ui.controller import EasyAnimateController
from tests.test_torch_mmdit import _rope, port_mmdit_cfg
from tests.test_torch_safetensors import write_tiny_model_dir

# float32 products of the same int32 accumulators and scales, in the same
# order: the outputs agree to float32 rounding
F32_TOL = 1e-6
# the tiny MMDiT against JAX's linear_quant model: the bounds
# tests/test_quant.py:502 holds between two JAX forwards (W4A8's int8
# activations flip on ties the float paths do not see)
MODEL_TOL = {"int8": (2e-4, 2e-3), "int4": (2e-4, 2e-3), "w4a8": (4e-3, 6e-3)}


def _np(t):
    return t.detach().numpy()


def _weight(rng, fan_in, out):
    """A JAX-layout [in, out] float32 weight with one outlier column."""
    w = rng.standard_normal((fan_in, out)).astype(np.float32) * 0.05
    w[:, 3] *= 8.0
    return w


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("fan_in,out", [(256, 64), (200, 64)])
def test_weight_quantizers_match_jax_bit_for_bit(rng, mode, fan_in, out):
    """(256, 64): two int4 groups of 128; (200, 64): one group. The port's
    [out, in] layout is JAX's transposed."""
    w = _weight(rng, fan_in, out)
    jfn = {"int8": jquant.quantize_weight_int8,
           "int4": jquant.quantize_weight_int4}[mode]
    tfn = {"int8": tquant.quantize_weight_int8,
           "int4": tquant.quantize_weight_int4}[mode]
    jq, js = (np.asarray(a) for a in jfn(jnp.asarray(w)))
    tq, ts = tfn(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(_np(tq), jq.T)
    np.testing.assert_array_equal(_np(ts), js.T)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    if mode == "int4":
        assert ts.shape == (out, fan_in // 128 if fan_in % 128 == 0 else 1)
        assert tq.shape == (out, fan_in // 2)
        # the nibbles unpack and dequantize as JAX's do
        np.testing.assert_array_equal(
            _np(tquant.unpack_int4(tq, fan_in)),
            np.asarray(jquant.unpack_int4(jnp.asarray(jq), fan_in)).T)
        np.testing.assert_array_equal(
            _np(tquant.dequantize_int4(tq, ts)),
            np.asarray(jquant.dequantize_int4(jnp.asarray(jq),
                                              jnp.asarray(js))).T)
    else:
        np.testing.assert_array_equal(
            _np(tquant.quantize_weight(torch.from_numpy(w.T.copy()))[0]),
            np.asarray(jquant.quantize_weight(jnp.asarray(w))[0]).T)


def test_int4_odd_fan_in_raises():
    w = np.ones((63, 8), np.float32)
    with pytest.raises(ValueError, match="even fan_in"):
        jquant.quantize_weight_int4(jnp.asarray(w))
    with pytest.raises(ValueError, match="even fan_in"):
        tquant.quantize_weight_int4(torch.from_numpy(w.T.copy()))
    with pytest.raises(ValueError, match="even fan_in"):
        tquant.QuantLinear(63, 8, "w4a8")


def _jax_activation_quant(x):
    """JAX int8_matmul's activation step (easyanimate_tpu/ops/quant.py:
    35-38), spelled out to read its int8 values."""
    xf = jnp.asarray(x, jnp.float32)
    ax = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-12)
    return jnp.round(xf * (127.0 / ax)).astype(jnp.int8), ax


def _inputs(rng, dtype, fan_in=256, out=64):
    x = rng.standard_normal((2, 7, fan_in)).astype(np.float32)
    x[0, 3] *= 8.0  # an outlier token
    if dtype == "bfloat16":  # both packages round float32 -> bf16 RNE
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, _weight(rng, fan_in, out), \
        rng.standard_normal(out).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_matmul_matches_jax(rng, dtype, with_bias):
    x, w, b = _inputs(rng, dtype)
    jq, js = jquant.quantize_weight_int8(jnp.asarray(w))
    tq, ts = tquant.quantize_weight_int8(torch.from_numpy(w.T.copy()))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    # the int8 activations and the int32 accumulators: exact
    xq_t, ax_t = tquant.quantize_rows(xt.reshape(-1, x.shape[-1]))
    xq_j, ax_j = _jax_activation_quant(jnp.asarray(x).reshape(-1, x.shape[-1]))
    np.testing.assert_array_equal(_np(xq_t), np.asarray(xq_j))
    np.testing.assert_array_equal(_np(ax_t), np.asarray(ax_j))
    acc_t = tquant.int_mm(xq_t, tq)
    acc_j = jax.lax.dot_general(xq_j, jq, (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(_np(acc_t), np.asarray(acc_j))
    # the output, 3-D in and out
    bias_j = jnp.asarray(b) if with_bias else None
    bias_t = torch.from_numpy(b) if with_bias else None
    want = jquant.int8_matmul(jnp.asarray(x), jq, js, bias_j, jnp.float32)
    got = tquant.int8_matmul(xt, tq, ts, bias_t, torch.float32)
    assert got.shape == x.shape[:-1] + (w.shape[1],)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("mode", ["int4", "w4a8"])
@pytest.mark.parametrize("fan_in", [256, 200])
def test_int4_matmuls_match_jax(rng, mode, fan_in):
    """W4A16 (the dequantized weight exact) and W4A8 (the regridded int8
    weight and s8 exact, its int32 accumulators exact), with bias, on a 3-D
    input, two groups and one."""
    x, w, b = _inputs(rng, "float32", fan_in=fan_in)
    jp, js = jquant.quantize_weight_int4(jnp.asarray(w))
    tp, ts = tquant.quantize_weight_int4(torch.from_numpy(w.T.copy()))
    xt = torch.from_numpy(x)
    if mode == "int4":
        wt = tquant.unpack_int4_weight(tp, ts, torch.float32)
        np.testing.assert_array_equal(
            _np(wt), np.asarray(jquant.dequantize_int4(jp, js)).T)
        want = jquant.int4_matmul(jnp.asarray(x), jp, js, jnp.asarray(b),
                                  jnp.float32)
        got = tquant.int4_matmul(xt, tp, ts, torch.from_numpy(b),
                                 torch.float32)
    else:
        q8, s8 = tquant.unpack_int4_weight(tp, ts, "int8")
        groups = js.shape[0]
        q4 = jquant.unpack_int4(jp, fan_in).reshape(groups, -1, w.shape[1])
        s8_j = jnp.maximum(jnp.max(js, axis=-2), 1e-12) * (8.0 / 127.0)
        q8_j = jnp.round(q4 * (js[:, None, :] / s8_j[None, None, :]))
        q8_j = q8_j.astype(jnp.int8).reshape(fan_in, w.shape[1])
        np.testing.assert_array_equal(_np(q8), np.asarray(q8_j).T)
        np.testing.assert_array_equal(_np(s8), np.asarray(s8_j))
        xq_t, _ = tquant.quantize_rows(xt.reshape(-1, fan_in))
        xq_j, _ = _jax_activation_quant(jnp.asarray(x).reshape(-1, fan_in))
        np.testing.assert_array_equal(
            _np(tquant.int_mm(xq_t, q8)),
            np.asarray(jax.lax.dot_general(
                xq_j, q8_j, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.int32)))
        want = jquant.int4_matmul_a8(jnp.asarray(x), jp, js, jnp.asarray(b),
                                     jnp.float32)
        got = tquant.int4_matmul_a8(xt, tp, ts, torch.from_numpy(b),
                                    torch.float32)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


def test_cpu_tensors_take_the_plain_versions_without_a_launch(rng):
    x, w, b = _inputs(rng, "bfloat16")
    xt = torch.from_numpy(x).to(torch.bfloat16).reshape(-1, x.shape[-1])
    p, s = tquant.quantize_weight_int4(torch.from_numpy(w.T.copy()))
    counters = (tquant.quantize_rows, tquant.dequantize_rows,
                tquant.unpack_int4_weight)
    before = [f.launches for f in counters]
    xq, ax = tquant.quantize_rows(xt)
    want = tquant.quantize_rows_plain(xt)
    assert torch.equal(xq, want[0]) and torch.equal(ax, want[1])
    acc = tquant.int_mm(xq, tquant.quantize_weight_int8(
        torch.from_numpy(w.T.copy()))[0])
    ws = torch.rand(w.shape[1])
    assert torch.equal(tquant.dequantize_rows(acc, ax, ws),
                       tquant.dequantize_rows_plain(acc, ax, ws))
    q8, s8 = tquant.unpack_int4_weight(p, s)
    assert torch.equal(q8, tquant.regrid_int4_plain(p, s)[0])
    assert tquant.unpack_int4_weight(p, s, torch.bfloat16).dtype == \
        torch.bfloat16
    assert [f.launches for f in counters] == before


def _tiny_cfgs(swa_layers=(1,), scan_layers=True):
    """(JAX float config, port float config): the 6-head tiny MMDiT."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], num_attention_heads=6,
                               swa_layers=swa_layers, attn_impl="xla",
                               scan_layers=scan_layers)
    return jcfg, port_mmdit_cfg(jcfg)


def _port_float_model(cfg, seed=0):
    """The tiny port model with random weights, biases and norm affines."""
    gen = torch.Generator().manual_seed(seed)
    model = EasyAnimateTransformer3D(cfg, device="cpu")
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen)
                    / max(1, p[0].numel()) ** 0.5 if p.dim() > 1
                    else p + 0.1 * torch.randn(p.shape, generator=gen))
    return model


def _jax_variables(model, jcfg):
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return jconvert.convert_mmdit_state_dict(sd, jcfg)


def _quantize_port(model, mode):
    if mode == "int8":
        return tquant.quantize_module_int8_(model)
    return tquant.quantize_module_int4_(model, mode)


def _quantize_jax(variables, mode):
    if mode == "int8":
        return jquant.quantize_params_int8(variables)
    return jquant.quantize_params_int4(variables)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("swa_layers,scan_layers", [(None, True),
                                                    ((1,), True),
                                                    (None, False)])
def test_carrier_gives_the_port_quantizers_state(mode, swa_layers,
                                                 scan_layers):
    """JAX's quantized trees (one scan stack, segments around an SWA
    layer, per-layer blocks) carry to exactly the state the port's own
    quantizers give."""
    jcfg, cfg = _tiny_cfgs(swa_layers, scan_layers)
    model = _port_float_model(cfg)
    jtree = _quantize_jax(_jax_variables(model, jcfg), mode)
    carried = tconvert.quantized_linears_from_jax(
        jax.tree.map(np.asarray, jtree))
    state = _quantize_port(model, mode).state_dict()
    quantized = {k for k in state if k.endswith(".scale")}
    assert len(quantized) == 2 * 12  # 2 layers, 12 block linears each
    assert set(carried) == quantized | {k[:-len("scale")] + "weight"
                                        for k in quantized}
    for k, v in carried.items():
        assert v.dtype == state[k].dtype and torch.equal(v, state[k]), k
    float_tree = {"blocks": {"block": {
        "norm1": {"linear": {"kernel": np.zeros((2, 4, 4), np.float32)}},
        "ff": {"wi": {"kernel": np.zeros((2, 4, 4), np.float32),
                      "scale": np.ones((2, 4), np.float32)}}}}}
    with pytest.raises(ValueError, match="not a quantized kernel"):
        tconvert.quantized_linears_from_jax(float_tree)


@pytest.mark.parametrize("mode", ["int8", "int4", "w4a8"])
def test_tiny_mmdit_matches_jax_linear_quant(rng, mode):
    """The tiny MMDiT with one SWA layer, quantized from the same float
    weights, against JAX's linear_quant model."""
    jcfg, cfg = _tiny_cfgs()
    model = _port_float_model(cfg)
    jtree = _quantize_jax(_jax_variables(model, jcfg), mode)
    jmodel = JaxModel(dataclasses.replace(jcfg, linear_quant=mode))
    _quantize_port(model, mode)
    assert model.cfg.linear_quant == mode
    n_quant = sum(isinstance(m, tquant.QuantLinear) for m in model.modules())
    assert n_quant == 24
    # the adaLN linears and everything outside the blocks stay float
    assert isinstance(model.transformer_blocks[0].norm1.linear,
                      torch.nn.Linear)
    assert isinstance(model.proj_out, torch.nn.Linear)
    b, f, hh, ww = 2, 2, 8, 8
    lat = rng.standard_normal((b, cfg.in_channels, f, hh, ww)).astype(np.float32)
    t = np.array([421.0, 17.0], np.float32)
    txt = rng.standard_normal((b, 5, cfg.text_embed_dim)).astype(np.float32)
    cos, sin = _rope(cfg.attention_head_dim, f, hh // 2, ww // 2)
    want = jmodel.apply(jtree, jnp.asarray(lat), jnp.asarray(t),
                        jnp.asarray(txt), (jnp.asarray(cos), jnp.asarray(sin)))
    with torch.no_grad():
        got = model(torch.from_numpy(lat), torch.from_numpy(t),
                    torch.from_numpy(txt),
                    (torch.from_numpy(cos), torch.from_numpy(sin)))
    atol, rtol = MODEL_TOL[mode]
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_merge_lora_into_quantized_weights_matches_jax(mode):
    """merge_lora into int8 and packed int4 weights requantizes in
    dequantized space with fresh scales, as JAX's: the same int values;
    the scales to float32 rounding (the delta's float32 sums run in
    another order in the two packages' matmuls). The unmerge comes back
    within one quantization step."""
    jcfg, cfg = _tiny_cfgs(None, scan_layers=False)
    model = _port_float_model(cfg)
    jparams = _quantize_jax(_jax_variables(model, jcfg), mode)["params"]
    _quantize_port(model, mode)
    lcfg = tlora.LoRAConfig(rank=4, alpha=8.0)
    targets = tlora.target_modules(model, lcfg)
    assert len(targets) == 24 and all(
        isinstance(m, tquant.QuantLinear) for m in targets.values())
    gen = torch.Generator().manual_seed(1)
    lora = tlora.lora_init(model, lcfg, gen)
    for fac in lora.values():
        fac["up"] = 0.05 * torch.randn(fac["up"].shape, generator=gen)
    to_jax = {v: k for k, v in tconvert._JAX_QUANT_LINEARS.items()}
    jlora_tree = {}
    for path, fac in lora.items():
        layer, linear = path.split(".", 2)[1:]
        jlora_tree[f"block{layer}/{to_jax[linear]}/kernel"] = {
            "down": jnp.asarray(_np(fac["down"])),
            "up": jnp.asarray(_np(fac["up"]))}
    jcfg_lora = jlora.LoRAConfig(rank=4, alpha=8.0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    want = tconvert.quantized_linears_from_jax(jax.tree.map(
        np.asarray, jlora.merge_lora(jparams, jlora_tree, jcfg_lora)))
    tlora.merge_lora(model, lora, lcfg)
    got = model.state_dict()
    for k, v in want.items():
        if v.dtype == torch.int8:
            assert (got[k] != before[k]).any(), k  # the merge moved it
            assert torch.equal(got[k], v), k
        else:
            np.testing.assert_allclose(_np(got[k]), _np(v), rtol=F32_TOL,
                                       atol=0, err_msg=k)
    tlora.unmerge_lora(model, lora, lcfg)
    for path in lora:
        mod = model.get_submodule(path)
        w0, s0 = before[path + ".weight"], before[path + ".scale"]
        w0 = (w0.float() * s0[:, None] if mode == "int8"
              else tquant.dequantize_int4(w0, s0))
        err = (mod.dequantized_weight() - w0).abs()
        assert err.max() <= 1.5 * mod.scale.amax(), path


def test_export_of_a_quantized_model_raises(tmp_path):
    _, cfg = _tiny_cfgs(None)
    model = tquant.quantize_module_int8_(_port_float_model(cfg))
    with pytest.raises(ValueError, match="float transformer"):
        tconvert.mmdit_config_json(model.cfg)
    with pytest.raises(ValueError, match="float transformer"):
        tconvert.save_reference_checkpoint(str(tmp_path / "t"),
                                           model.state_dict())
    with pytest.raises(ValueError, match="float transformer"):
        tconvert.save_reference_checkpoint(
            str(tmp_path / "n"), {k: v.numpy() for k, v in
                                  model.state_dict().items()})
    assert not (tmp_path / "t").exists()


@pytest.mark.parametrize("kw,mode", [
    ({"int8_linears": True}, "int8"),
    ({"int4_weights": True}, "w4a8"),
    ({"int4_weights": True, "int4_compute": "bf16"}, "int4")])
def test_update_diffusion_transformer_keeps_the_quant_mode(tmp_path, kw,
                                                           mode):
    root = str(tmp_path / "EasyAnimateV5.1-12b-zh")
    write_tiny_model_dir(root)
    ctl = EasyAnimateController(pipeline=load_pipeline(
        root, dtype="float32", fp8_weights=True, device="cpu", **kw))
    old = ctl.pipeline
    assert old.transformer.cfg.linear_quant == mode
    ctl.update_diffusion_transformer(root)
    new = ctl.pipeline
    assert new is not old and new.transformer.cfg.linear_quant == mode
    modes = {m.mode for m in new.transformer.modules()
             if isinstance(m, tquant.QuantLinear)}
    assert modes == {mode}
    assert any(p.dtype == torch.float8_e4m3fn
               for p in new.transformer.parameters())
    for (k, a), b in zip(old.transformer.state_dict().items(),
                         new.transformer.state_dict().values()):
        assert a.dtype == b.dtype and torch.equal(a.float(), b.float()), k
