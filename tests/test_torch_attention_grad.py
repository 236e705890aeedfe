"""Gradients of the port's attention (easyanimate_tpu_torch.ops) against the
JAX package: the plain backward versions of K3/K4 and K6/K7 against the
JAX backward kernels in interpret mode, the differentiable entry points
against the JAX entry points, and the tiny MMDiT's parameter gradients
against jax.grad of the same loss.

Inputs come from a numpy seed and go through both packages in float32.
Tolerances: 2e-4 (absolute and relative) for attention gradients, the JAX
kernel tests' bound (tests/test_swa.py) -- both sides sum the same float32
products in another order; 5e-4 of the largest gradient for the model,
the JAX full-model golden test's bound (tests/test_mmdit_full_golden.py),
taken relative because parameter gradients span four decades.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.models.mmdit import PRESETS as JAX_PRESETS
from easyanimate_tpu.ops import flash_attention as jfa
from easyanimate_tpu.ops import swa as jswa
from easyanimate_tpu_torch.models.convert import load_reference_state_dict
from easyanimate_tpu_torch.models.mmdit import EasyAnimateTransformer3D
from easyanimate_tpu_torch.ops import attention as tattn
from easyanimate_tpu_torch.ops import flash_attention as tfa
from easyanimate_tpu_torch.ops import swa as tswa
from easyanimate_tpu_torch.ops.rope import (get_3d_rotary_pos_embed,
                                            get_resize_crop_region_for_grid)
from test_torch_mmdit import export_jax_mmdit, port_mmdit_cfg

jattn = importlib.import_module("easyanimate_tpu.ops.attention")

GRAD_TOL = 2e-4
MODEL_TOL = 5e-4


def _np(x):
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol=GRAD_TOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _pad_rows(a, n):
    return np.pad(a, ((0, 0), (0, n - a.shape[1]), (0, 0)))


def _round_up(x, m):
    return -(-x // m) * m


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# plain backward versions against the JAX kernels (K3/K4, K6/K7)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv,kv_valid,d", [
    (200, 300, 300, 64),   # ragged on both sides
    (256, 256, 200, 64),   # kv_valid < S
    (130, 150, 111, 16),   # ragged, masked, head_dim 16
])
def test_flash_bwd_plain_matches_jax_kernels(rng, sq, skv, kv_valid, d):
    """(dq, dk, dv) of flash_attention_bwd_plain against jax.vjp of the
    JAX kernel-level custom_vjp, which runs K3 and K4 in interpret mode on
    the same pre-scaled q; dk/dv rows past kv_valid are exactly 0."""
    bh, blk = 2, 128
    qf = _randn(rng, bh, sq, d) * (d ** -0.5 * tfa.LOG2E)
    k, v, do = _randn(rng, bh, skv, d), _randn(rng, bh, skv, d), _randn(rng, bh, sq, d)
    # the Pallas kernels take block-multiple inputs, k/v zero past kv_valid,
    # and a zero cotangent on the padded q rows (the JAX wrapper slices them)
    kz, vz = k.copy(), v.copy()
    kz[:, kv_valid:] = 0
    vz[:, kv_valid:] = 0
    sqp, skvp = _round_up(sq, blk), _round_up(skv, blk)
    o_j, vjp = jax.vjp(
        lambda a, b, c: jfa._flash_attention(a, b, c, kv_valid, blk, blk, True),
        *(jnp.asarray(_pad_rows(a, n)) for a, n in ((qf, sqp), (kz, skvp), (vz, skvp))))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(_pad_rows(do, sqp)))

    qt, kt, vt, dot = map(torch.from_numpy, (qf, k, v, do))
    o, lse = tfa.flash_attention_plain(qt, kt, vt, kv_valid)
    _close(o, np.asarray(o_j)[:, :sq])
    dq, dk, dv = tfa.flash_attention_bwd_plain(qt, kt, vt, o, lse, dot, kv_valid)
    _close(dq, np.asarray(dq_j)[:, :sq])
    _close(dk[:, :kv_valid], np.asarray(dk_j)[:, :kv_valid])
    _close(dv[:, :kv_valid], np.asarray(dv_j)[:, :kv_valid])
    assert not dk[:, kv_valid:].any() and not dv[:, kv_valid:].any()
    # a CPU tensor takes the plain version through the wrapper, no launch
    n = tfa.flash_attention_bwd.launches
    for a, b in zip(tfa.flash_attention_bwd(qt, kt, vt, o, lse, dot, kv_valid),
                    (dq, dk, dv)):
        assert torch.equal(a, b)
    assert tfa.flash_attention_bwd.launches == n


@pytest.mark.parametrize("s,window,d", [(200, 50, 64), (384, 100, 32),
                                        (150, 20, 16), (130, 0, 64),
                                        (100, 150, 32)])
def test_swa_bwd_plain_matches_jax_kernels(rng, s, window, d):
    """(dq, dk, dv) of sliding_window_bwd_plain against jax.vjp of the JAX
    custom_vjp over K2, whose backward runs K6 and K7 in interpret mode
    (ragged S at 200, 150, 130 and 100; window 0, and a window past S,
    where every row sees every column)."""
    bh, blk = 2, 128
    qf = _randn(rng, bh, s, d) * (d ** -0.5 * tfa.LOG2E)
    k, v, do = _randn(rng, bh, s, d), _randn(rng, bh, s, d), _randn(rng, bh, s, d)
    sp = _round_up(s, blk)
    o_j, vjp = jax.vjp(
        lambda a, b, c: jswa._swa_attention(a, b, c, window, s, blk, blk,
                                            True, blk),
        *(jnp.asarray(_pad_rows(a, sp)) for a in (qf, k, v)))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(_pad_rows(do, sp)))

    qt, kt, vt, dot = map(torch.from_numpy, (qf, k, v, do))
    o, lse = tswa.sliding_window_plain(qt, kt, vt, window)
    _close(o, np.asarray(o_j)[:, :s])
    grads = tswa.sliding_window_bwd_plain(qt, kt, vt, o, lse, dot, window)
    for got, want in zip(grads, (dq_j, dk_j, dv_j)):
        _close(got, np.asarray(want)[:, :s])
    # small blocks so the banded span clamps at both sequence ends
    for a, b in zip(tswa.sliding_window_bwd_plain(qt, kt, vt, o, lse, dot,
                                                  window, block_q=64), grads):
        _close(a, b, 1e-5)


# ---------------------------------------------------------------------------
# the differentiable entry points: the sm_scale * log2(e) chain rule
# ---------------------------------------------------------------------------


def _torch_vjp(fn, arrays, cotangents):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    outs = fn(*ts)
    outs = outs if isinstance(outs, tuple) else (outs,)
    torch.autograd.backward(outs, [torch.from_numpy(c) for c in cotangents])
    return outs, [t.grad for t in ts]


def _jax_vjp(fn, arrays, cotangents):
    outs, vjp = jax.vjp(fn, *map(jnp.asarray, arrays))
    outs = outs if isinstance(outs, tuple) else (outs,)
    cts = tuple(map(jnp.asarray, cotangents))
    return outs, vjp(cts if len(cts) > 1 else cts[0])


@pytest.mark.parametrize("sq,skv,kv_valid", [(200, 200, None), (100, 256, 180)])
def test_attention_grad_matches_jax(rng, sq, skv, kv_valid):
    b, h, d = 1, 3, 64
    q, k, v = _randn(rng, b, h, sq, d), _randn(rng, b, h, skv, d), _randn(rng, b, h, skv, d)
    if kv_valid is not None:  # the JAX kernel's contract: k/v zero past it
        k[:, :, kv_valid:] = 0
        v[:, :, kv_valid:] = 0
    do = _randn(rng, b, h, sq, d)
    outs_j, grads_j = _jax_vjp(
        lambda a, b_, c: jattn.attention(a, b_, c, kv_valid=kv_valid,
                                         impl="pallas_interpret", block_q=128,
                                         block_kv=128, block_kv_inner=128),
        (q, k, v), (do,))
    outs_t, grads_t = _torch_vjp(
        lambda a, b_, c: tattn.attention(a, b_, c, kv_valid=kv_valid),
        (q, k, v), (do,))
    _close(outs_t[0], outs_j[0])
    n = kv_valid or skv  # JAX's dk/dv past kv_valid are its pad garbage
    _close(grads_t[0], grads_j[0])
    for g_t, g_j in zip(grads_t[1:], grads_j[1:]):
        _close(g_t[:, :, :n], np.asarray(g_j)[:, :, :n])
        assert not g_t[:, :, n:].any()


def test_joint_attention_grad_matches_jax(rng):
    b, h, st, sv, d = 1, 2, 5, 16, 16
    arrs = [_randn(rng, b, h, n, d) for n in (st, st, st, sv, sv, sv)]
    cts = [_randn(rng, b, h, st, d), _randn(rng, b, h, sv, d)]
    cos, sin = get_3d_rotary_pos_embed(
        d, get_resize_crop_region_for_grid((2, 4), 45, 30), (2, 4), 2)
    outs_j, grads_j = _jax_vjp(
        lambda *a: jattn.joint_attention(*a, jnp.asarray(cos), jnp.asarray(sin),
                                         impl="pallas_interpret"), arrs, cts)
    outs_t, grads_t = _torch_vjp(
        lambda *a: tattn.joint_attention(*a, torch.from_numpy(cos),
                                         torch.from_numpy(sin)), arrs, cts)
    for got, want in zip(list(outs_t) + grads_t, list(outs_j) + list(grads_j)):
        _close(got, want)


@pytest.mark.parametrize("nh", [6, 8])
def test_swa_streams_grad_matches_jax(rng, nh):
    """Through the 6-direction permutes, the uneven tensor_split groups
    (nh=8), the strided cross kv and text out = 2 x cross."""
    b, st, d = 1, 7, 16
    f, hh, ww = 3, 4, 5
    sv = f * hh * ww
    kw = dict(num_frames=f, height=hh, width=ww, cross_attention_size=27)
    arrs = [_randn(rng, b, nh, n, d) for n in (st, st, st, sv, sv, sv)]
    cts = [_randn(rng, b, nh, st, d), _randn(rng, b, nh, sv, d)]
    outs_j, grads_j = _jax_vjp(
        lambda *a: jswa.swa_attention_streams(*a, impl="pallas_interpret", **kw),
        arrs, cts)
    outs_t, grads_t = _torch_vjp(
        lambda *a: tswa.swa_attention_streams(*a, **kw), arrs, cts)
    for got, want in zip(list(outs_t) + grads_t, list(outs_j) + list(grads_j)):
        _close(got, want)


# ---------------------------------------------------------------------------
# the tiny model's parameter gradients
# ---------------------------------------------------------------------------


def _model_loss_inputs(rng, jcfg, b=1, f=2, hh=8, ww=8, text_len=5):
    lat = _randn(rng, b, jcfg.in_channels, f, hh, ww)
    target = _randn(rng, b, jcfg.out_channels, f, hh, ww)
    t = np.array([421.0] * b, np.float32)
    txt = _randn(rng, b, text_len, jcfg.text_embed_dim)
    crop = get_resize_crop_region_for_grid((hh // 2, ww // 2), 45, 30)
    rope = get_3d_rotary_pos_embed(jcfg.attention_head_dim, crop,
                                   (hh // 2, ww // 2), f)
    return lat, t, txt, rope, target


@pytest.mark.parametrize("swa_layers", [None, (1,)])
def test_tiny_model_grads_match_jax(rng, swa_layers):
    """d(MSE)/d(params) of the tiny transformer (6 heads, dense and with an
    SWA layer), weights carried by export_mmdit_state_dict, against
    jax.grad of the same loss exported the same way; remat on and off give
    the same gradients."""
    from easyanimate_tpu.models import convert as jconvert

    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], num_attention_heads=6,
                               swa_layers=swa_layers,
                               attn_impl="pallas_interpret")
    model, variables, sd = export_jax_mmdit(jcfg)
    lat, t, txt, (cos, sin), target = _model_loss_inputs(rng, jcfg)

    def jloss(params):
        pred = model.apply({"params": params}, jnp.asarray(lat), jnp.asarray(t),
                           jnp.asarray(txt), (jnp.asarray(cos), jnp.asarray(sin)))
        return jnp.mean(jnp.square(pred - jnp.asarray(target)))

    loss_j, grads_j = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    want = jconvert.export_mmdit_state_dict({"params": grads_j}, jcfg)

    grads = {}
    for remat in (True, False):
        port = EasyAnimateTransformer3D(dataclasses.replace(
            port_mmdit_cfg(jcfg), remat=remat), device="cpu")
        load_reference_state_dict(port, sd)
        pred = port(*map(torch.from_numpy, (lat, t, txt)),
                    (torch.from_numpy(cos), torch.from_numpy(sin)))
        loss = (pred - torch.from_numpy(target)).square().mean()
        loss.backward()
        _close(loss, loss_j, MODEL_TOL)
        # the last block's text stream never reaches the loss: zero in JAX
        grads[remat] = {n: torch.zeros_like(p) if p.grad is None else p.grad
                        for n, p in port.named_parameters()}
    assert set(grads[True]) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(_np(grads[True][name]), w,
                                   atol=MODEL_TOL * scale, rtol=MODEL_TOL,
                                   err_msg=name)
        torch.testing.assert_close(grads[True][name], grads[False][name],
                                   atol=1e-6, rtol=1e-5)
