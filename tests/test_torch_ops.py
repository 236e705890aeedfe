"""Parity of the PyTorch port's ops (easyanimate_tpu_torch.ops) with the JAX
package, plus the port's guards.

Inputs come from a numpy seed and go through both packages in float32.
Where the JAX function reaches a Pallas kernel it runs in interpret mode.
Tolerances: 2e-4 for attention, the JAX kernel tests' own bound
(tests/test_swa.py); 1e-5 for the elementwise norms and RoPE.
"""
import importlib
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.ops import flash_attention as jfa
from easyanimate_tpu.ops import norms as jnorms
from easyanimate_tpu.ops import rope as jrope
from easyanimate_tpu.ops import swa as jswa
from easyanimate_tpu_torch.ops import _build
from easyanimate_tpu_torch.ops import attention as tattn
from easyanimate_tpu_torch.ops import flash_attention as tfa
from easyanimate_tpu_torch.ops import norms as tnorms
from easyanimate_tpu_torch.ops import rope as trope
from easyanimate_tpu_torch.ops import swa as tswa

# the JAX ops package re-exports a function named `attention`
jattn = importlib.import_module("easyanimate_tpu.ops.attention")

ATTN_TOL = 2e-4
REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "easyanimate_tpu_torch"


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _pad_rows(a, n):
    """Zero-pad axis 1 of [bh, S, d] to n rows."""
    return np.pad(a, ((0, 0), (0, n - a.shape[1]), (0, 0)))


def _round_up(x, m):
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# norms and RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("affine", [False, True])
def test_fp32_layer_norm_matches_jax(rng, affine):
    x = rng.standard_normal((2, 7, 32)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(32).astype(np.float32) if affine else None
    b = rng.standard_normal(32).astype(np.float32) if affine else None
    want = jnorms.fp32_layer_norm(jnp.asarray(x), None if w is None else
                                  jnp.asarray(w), None if b is None else
                                  jnp.asarray(b), 1e-6)
    got = tnorms.fp32_layer_norm(torch.from_numpy(x), None if w is None else
                                 torch.from_numpy(w), None if b is None else
                                 torch.from_numpy(b), 1e-6)
    _close(got, want, 1e-5)


def test_fp32_rms_norm_matches_jax(rng):
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    w = rng.standard_normal(24).astype(np.float32)
    _close(tnorms.fp32_rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jnorms.fp32_rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-5)


@pytest.mark.parametrize("grid,frames", [((24, 42), 13), ((4, 4), 2),
                                         ((30, 45), 1), ((36, 20), 3)])
def test_rope_tables_match_jax(grid, frames):
    crop_j = jrope.get_resize_crop_region_for_grid(grid, 45, 30)
    crop_t = trope.get_resize_crop_region_for_grid(grid, 45, 30)
    assert crop_t == crop_j
    cos_j, sin_j = jrope.get_3d_rotary_pos_embed(64, crop_j, grid, frames)
    cos_t, sin_t = trope.get_3d_rotary_pos_embed(64, crop_t, grid, frames)
    np.testing.assert_array_equal(cos_t, cos_j)
    np.testing.assert_array_equal(sin_t, sin_j)
    pos = np.arange(5, dtype=np.float32)
    for a, b in zip(trope.get_1d_rotary_pos_embed(16, pos),
                    jrope.get_1d_rotary_pos_embed(16, pos)):
        np.testing.assert_array_equal(a, b)


def test_apply_rotary_emb_matches_jax(rng):
    x = rng.standard_normal((2, 3, 16, 64)).astype(np.float32)
    cos, sin = trope.get_3d_rotary_pos_embed(
        64, trope.get_resize_crop_region_for_grid((2, 4), 45, 30), (2, 4), 2)
    want = jrope.apply_rotary_emb(jnp.asarray(x), jnp.asarray(cos),
                                  jnp.asarray(sin))
    got = trope.apply_rotary_emb(torch.from_numpy(x), torch.from_numpy(cos),
                                 torch.from_numpy(sin))
    _close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# K1: dense flash-attention forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sq,skv,kv_valid,d", [
    (256, 256, 256, 64),   # tile multiples, no mask
    (200, 300, 300, 64),   # ragged S on both sides
    (256, 256, 200, 64),   # kv_valid < S
    (130, 150, 111, 16),   # ragged, masked, head_dim 16
])
def test_flash_plain_matches_jax_kernel(rng, sq, skv, kv_valid, d):
    """o and the base-2 lse of K1's plain version against the Pallas
    forward kernel in interpret mode, on the same pre-scaled q."""
    bh, blk = 3, 128
    q = rng.standard_normal((bh, sq, d)).astype(np.float32)
    k = rng.standard_normal((bh, skv, d)).astype(np.float32)
    v = rng.standard_normal((bh, skv, d)).astype(np.float32)
    qf = q * (d ** -0.5 * tfa.LOG2E)
    # the Pallas kernel needs block-multiple inputs with k/v zero past
    # kv_valid; the port takes the ragged arrays with garbage past kv_valid
    kz, vz = k.copy(), v.copy()
    kz[:, kv_valid:] = 0
    vz[:, kv_valid:] = 0
    o_j, lse_j = jfa._flash_fwd(
        jnp.asarray(_pad_rows(qf, _round_up(sq, blk))),
        jnp.asarray(_pad_rows(kz, _round_up(skv, blk))),
        jnp.asarray(_pad_rows(vz, _round_up(skv, blk))),
        kv_valid, blk, blk, True)
    o_t, lse_t = tfa.flash_attention_fwd(torch.from_numpy(qf),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), kv_valid)
    assert o_t.shape == (bh, sq, d) and lse_t.shape == (bh, sq, 1)
    _close(o_t, np.asarray(o_j)[:, :sq], ATTN_TOL)
    _close(lse_t, np.asarray(lse_j)[:, :sq], ATTN_TOL)


@pytest.mark.parametrize("s,kv_valid", [(200, None), (256, 180)])
def test_attention_matches_jax_pallas_interpret(rng, s, kv_valid):
    b, h, d = 2, 3, 64
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    if kv_valid is not None:  # the JAX kernel's contract: k/v zero past it
        k[:, :, kv_valid:] = 0
        v[:, :, kv_valid:] = 0
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           kv_valid=kv_valid, impl="pallas_interpret",
                           block_q=128, block_kv=128, block_kv_inner=128)
    got = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), kv_valid=kv_valid)
    _close(got, want, ATTN_TOL)
    plain = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), kv_valid=kv_valid,
                            impl="plain")
    _close(plain, want, ATTN_TOL)


def test_joint_attention_matches_jax(rng):
    b, h, st, sv, d = 1, 2, 5, 16, 16
    arrs = [rng.standard_normal((b, h, n, d)).astype(np.float32)
            for n in (st, st, st, sv, sv, sv)]
    cos, sin = trope.get_3d_rotary_pos_embed(
        d, trope.get_resize_crop_region_for_grid((2, 4), 45, 30), (2, 4), 2)
    want = jattn.joint_attention(*map(jnp.asarray, arrs), jnp.asarray(cos),
                                 jnp.asarray(sin), impl="pallas_interpret")
    got = tattn.joint_attention(*map(torch.from_numpy, arrs),
                                torch.from_numpy(cos), torch.from_numpy(sin))
    for g, w in zip(got, want):
        _close(g, w, ATTN_TOL)


# ---------------------------------------------------------------------------
# K2: sliding-window forward, and the 6-direction composition
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,window,d", [(256, 64, 64), (200, 50, 64),
                                        (384, 100, 64), (150, 20, 32),
                                        (130, 0, 64), (100, 150, 32)])
def test_swa_plain_matches_jax_kernel(rng, s, window, d):
    """o and lse of K2's plain version against the Pallas windowed kernel
    in interpret mode (ragged S at 200, 150, 130 and 100; window 0, and a
    window past S, where every row sees every column)."""
    bh, blk = 2, 128
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32)
               for _ in range(3))
    qf = q * (d ** -0.5 * tfa.LOG2E)
    sp = _round_up(s, blk)
    o_j, lse_j = jswa._swa_fwd(
        *(jnp.asarray(_pad_rows(a, sp)) for a in (qf, k, v)), window=window,
        kv_len=s, block_q=blk, block_kv=blk, block_kv_inner=blk,
        interpret=True)
    o_t, lse_t = tswa.sliding_window_fwd(*map(torch.from_numpy, (qf, k, v)),
                                         window)
    _close(o_t, np.asarray(o_j)[:, :s], ATTN_TOL)
    _close(lse_t, np.asarray(lse_j)[:, :s], ATTN_TOL)
    # small blocks so the banded span clamps at both ends
    o_b, lse_b = tswa.sliding_window_plain(
        *map(torch.from_numpy, (qf, k, v)), window, block_q=64)
    _close(o_b, o_t, 1e-5)
    _close(lse_b, lse_t, 1e-5)


def test_sliding_window_attention_matches_jax(rng):
    b, h, s, d, window = 1, 2, 200, 64, 50
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    want = jswa.sliding_window_attention(
        *map(jnp.asarray, (q, k, v)), window=window, block_q=128,
        block_kv=128, interpret=True)
    got = tswa.sliding_window_attention(*map(torch.from_numpy, (q, k, v)),
                                        window=window)
    _close(got, want, ATTN_TOL)


def test_permute_tokens_matches_jax(rng):
    f, h, w = 3, 4, 5
    x = rng.standard_normal((1, 2, f * h * w, 8)).astype(np.float32)
    for order in [None, (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]:
        for inverse in (False, True):
            want = jswa._permute_tokens(jnp.asarray(x), f, h, w, order, inverse)
            got = tswa._permute_tokens(torch.from_numpy(x), f, h, w, order,
                                       inverse)
            np.testing.assert_array_equal(_np(got), np.asarray(want))


@pytest.mark.parametrize("nh", [6, 8])
def test_swa_streams_match_jax(rng, nh):
    """nh=8 gives uneven tensor_split groups (2, 2, 1, 1, 1, 1). Also pins
    text out = 2 x cross and the strided cross kv at `interval`."""
    b, st, d = 1, 7, 16
    f, h, w = 3, 4, 5
    sv = f * h * w
    cross_size = 27  # interval = 60 // (27 - 7) = 3
    arrs = [rng.standard_normal((b, nh, n, d)).astype(np.float32)
            for n in (st, st, st, sv, sv, sv)]
    want = jswa.swa_attention_streams(
        *map(jnp.asarray, arrs), num_frames=f, height=h, width=w,
        cross_attention_size=cross_size, impl="pallas_interpret")
    got = tswa.swa_attention_streams(
        *map(torch.from_numpy, arrs), num_frames=f, height=h, width=w,
        cross_attention_size=cross_size)
    for g, wnt in zip(got, want):
        _close(g, wnt, ATTN_TOL)

    qt, kt, vt, qv, kv, vv = map(torch.from_numpy, arrs)
    idx = torch.arange(0, sv, 3)
    cross_txt = tattn.attention(qt, torch.cat([kt, kv[:, :, idx]], 2),
                                torch.cat([vt, vv[:, :, idx]], 2))
    _close(got[0], 2.0 * cross_txt, 1e-6)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import easyanimate_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'easyanimate_tpu')]\n"
        "assert not bad, bad\n"
        "need = {'easyanimate_tpu_torch.' + m for m in "
        "('training.losses', 'training.optim', 'training.trainer', "
        "'training.lora', 'pipeline.inpaint', 'utils.media', "
        "'training.came', 'training.adam8bit', 'training.checkpoints', "
        "'utils.diffusion', 'utils.observability', 'data.masks', "
        "'data.buckets', 'data.dataset', 'data.prefetch', 'train', "
        "'train_lora')}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_port_source_has_no_library_attention():
    banned = re.compile(r"scaled_dot_product_attention|torch\.compile|"
                        r"flash_attn|xformers|"
                        r"^\s*(import|from)\s+(jax|flax|easyanimate_tpu)\b")
    hits = []
    for path in PORT.rglob("*"):
        if path.suffix in (".py", ".cu", ".cuh"):
            for n, line in enumerate(path.read_text().splitlines(), 1):
                if banned.search(line):
                    hits.append(f"{path.relative_to(REPO)}:{n}: {line.strip()}")
    assert not hits, hits


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_library()
    assert not (tmp_path / "kernels").exists()


PTXAS_LOG = """== flash_fwd.cu
ptxas info    : Compiling entry function '_ZN2ea3k1_attn_kernel' for 'sm_90a'
ptxas info    : Function properties for _ZN2ea3k1_attn_kernel
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 27648 bytes smem
ptxas info    : Compiling entry function '_ZN2ea2k114flash_fwd_sm90E' for 'sm_90a'
ptxas info    : Function properties for _ZN2ea2k114flash_fwd_sm90E
    16 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 128 registers, used 16 barriers
ptxas warning : (C7508) setmaxnreg ignored
"""


def test_ptxas_report_reads_the_kept_build_log(monkeypatch, tmp_path):
    lib = tmp_path / "libea_kernels_0.so"
    monkeypatch.setattr(_build, "build_library", lambda: lib)
    _build._ptxas_log(lib).write_text(PTXAS_LOG)
    assert _build.ptxas_report("flash_fwd_sm90") == {
        "stack_bytes": 16, "spill_store_bytes": 16, "spill_load_bytes": 12,
        "registers": 128,
        "warnings": ["ptxas warning : (C7508) setmaxnreg ignored"]}
    assert _build.ptxas_report("attn_kernel")["registers"] == 128


SASS = """
\t.headerflags\t@"EF_CUDA_SM90"
\t\tFunction : _ZN2ea10attn_fwd_kernelILi16ELb0EEEvPKv
        /*0000*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], RZ, !UPT ;  /* 0x0 */
\t\tFunction : _ZN2ea2k114flash_fwd_sm90E14CUtensorMap_st
        /*02e0*/                   USETMAXREG.TRY_ALLOC.CTAPOOL UP0, 0xa0 ;  /* 0x000000a0000079c8 */
                                                                           /* 0x000e640008000600 */
        /*06b0*/                   STL.64 [R1+0x8], R16 ;                    /* 0x0000081001007387 */
        /*0810*/                   LDL.64 R16, [R1+0x8] ;                    /* 0x0000080001107983 */
        /*0940*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR12], RZ, !UPT ;  /* 0x0 */
        /*2840*/                   HGMMA.64x64x16.F32.BF16 R88, R24, gdesc[UR4].tnspB, R88 ;  /* 0x0 */
        /*3b00*/                   UTMALDG.3D [UR8], [UR4] ;                 /* 0x0 */
        /*3ee0*/                   EXIT ;                                    /* 0x0 */
"""


def test_sass_helpers_read_one_function(monkeypatch, tmp_path):
    """sass_counts / sass_sites read only the named function of cuobjdump's
    listing: opcode counts, and the matching instructions by address."""
    import types

    monkeypatch.setattr(_build, "find_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "build_library", lambda: tmp_path / "lib.so")
    monkeypatch.setattr(_build.subprocess, "run",
                        lambda cmd, **kw: types.SimpleNamespace(stdout=SASS))
    assert _build.sass_counts("flash_fwd_sm90", ("HGMMA", "STL", "LDL",
                                                 "UTMASTG")) == {
        "HGMMA": 2, "STL": 1, "LDL": 1, "UTMASTG": 0}
    assert _build.sass_sites("flash_fwd_sm90", ("STL", "LDL", "USETMAXREG",
                                                "EXIT")) == [
        "02e0: USETMAXREG.TRY_ALLOC.CTAPOOL UP0, 0xa0",
        "06b0: STL.64 [R1+0x8], R16", "0810: LDL.64 R16, [R1+0x8]",
        "3ee0: EXIT"]
    with pytest.raises(RuntimeError, match="no function matching"):
        _build.sass_counts("flash_bwd", ("HGMMA",))


def test_launch_raises_on_a_refused_tensor_map(monkeypatch):
    """A C entry point returns TENSOR_MAP_ERROR + the CUresult when
    cuTensorMapEncodeTiled fails; the wrapper raises, as on any error."""
    import contextlib
    import types

    lib = types.SimpleNamespace(
        ea_flash_fwd_bf16=lambda *a: _build.TENSOR_MAP_ERROR + 1,
        ea_swa_fwd_bf16=lambda *a: 700)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", contextlib.nullcontext)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=0))
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled failed "
                                           "with CUresult 1"):
        _build.launch("ea_flash_fwd_bf16", torch.device("cuda"))
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _build.launch("ea_swa_fwd_bf16", torch.device("cuda"))


def test_entry_point_signatures_match_the_sources():
    """The ctypes argtypes of every C entry point name one type per
    parameter of its extern "C" definition under csrc/, a pointer for each
    pointer and an int for each int: with one missing, ctypes passes the
    parameters after it in the wrong slots (the stream among them)."""
    src = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for name, argtypes in _build._SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        params = [p.strip() for p in m[1].split(",")]
        want = [_build._P if "*" in p else _build._I for p in params]
        assert list(argtypes) == want, name


def test_kernel_input_checks_reject_cpu_and_bad_dtype():
    x = torch.zeros(2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        _build.check_kernel_inputs(x, x, x)
    with pytest.raises(ValueError):
        tfa.flash_attention_fwd(x, x, x, kv_valid=9)


def test_cpu_tensors_take_plain_version_without_launch(rng):
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 40, 16))
                                .astype(np.float32)) for _ in range(3))
    n1, n2 = tfa.flash_attention_fwd.launches, tswa.sliding_window_fwd.launches
    n_sm90 = (tfa.flash_attention_fwd.launches_sm90,
              tswa.sliding_window_fwd.launches_sm90)
    o1, l1 = tfa.flash_attention_fwd(q, k, v)
    o2, l2 = tswa.sliding_window_fwd(q, k, v, 40)  # window covers all
    assert (tfa.flash_attention_fwd.launches, tswa.sliding_window_fwd.launches
            ) == (n1, n2)
    assert (tfa.flash_attention_fwd.launches_sm90,
            tswa.sliding_window_fwd.launches_sm90) == n_sm90
    _close(o1, o2, 1e-5)
    _close(l1, l2, 1e-5)


def test_cpu_backward_takes_plain_version_without_launch(rng):
    """flash_attention_bwd on CPU tensors is flash_attention_bwd_plain, and
    no kernel launch is counted."""
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 40, 16))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = tfa.flash_attention_fwd(q, k, v, 33)
    n, n_sm90 = (tfa.flash_attention_bwd.launches,
                 tfa.flash_attention_bwd.launches_sm90)
    got = tfa.flash_attention_bwd(q, k, v, o, lse, do, 33)
    assert (tfa.flash_attention_bwd.launches,
            tfa.flash_attention_bwd.launches_sm90) == (n, n_sm90)
    for a, b in zip(got, tfa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                       33)):
        assert torch.equal(a, b)
    assert not got[1][:, 33:].any() and not got[2][:, 33:].any()


def test_cpu_swa_backward_takes_plain_version_without_launch(rng):
    """sliding_window_bwd on CPU tensors is sliding_window_bwd_plain, and
    neither its launches nor K6's and K7's TMA + wgmma launches are
    counted."""
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 40, 16))
                                    .astype(np.float32)) for _ in range(4))
    o, lse = tswa.sliding_window_fwd(q, k, v, 7)
    counts = (tswa.sliding_window_bwd.launches,
              tswa.sliding_window_bwd.launches_sm90)
    got = tswa.sliding_window_bwd(q, k, v, o, lse, do, 7)
    assert (tswa.sliding_window_bwd.launches,
            tswa.sliding_window_bwd.launches_sm90) == counts
    for a, b in zip(got, tswa.sliding_window_bwd_plain(q, k, v, o, lse, do,
                                                       7)):
        assert torch.equal(a, b)
