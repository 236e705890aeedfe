"""Parity of the port's fused local + global SWA (K5's plain version,
SwaLocalGlobal, swa_attention_streams(fuse_cross=True)) with the JAX
package, whose Pallas kernel runs in interpret mode.

Inputs are made with numpy from a seed and handed to both packages, in
float32. Forward tolerance 2e-4, the attention bound of
tests/test_torch_ops.py (float32 softmax sums in another order); gradients
5e-4, the same sums taken twice more (recompute, then the backward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from easyanimate_tpu.ops import swa as jswa
from easyanimate_tpu_torch.ops import swa as tswa

ATTN_TOL = 2e-4
GRAD_TOL = 5e-4
# the three shapes of tests/test_swa.py's fused-stream test
STREAM_SHAPES = [
    (6, 3, 4, 4, 8, 16),      # even head split, interval > 1
    (8, 3, 4, 5, 7, 15),      # remainder heads (tensor_split: [2,2,1,1,1,1])
    (13, 2, 3, 4, 5, 1024),   # big remainder, interval == 1
]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=tol, rtol=tol)


def _jax_local_global(q, k, v, gk, gv, window):
    return jswa.swa_local_global(q, k, v, gk, gv, window, 128, 128, True, 128)


@pytest.mark.parametrize("s,sg,window", [(200, 37, 50), (256, 100, 64)])
def test_swa_local_global_matches_jax(rng, s, sg, window):
    """Forward and the gradients of q, k, v and the global kv against JAX
    swa_local_global(..., interpret=True) and its custom VJP."""
    b, h, d = 1, 2, 64
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for _ in range(3))
    gk, gv = (rng.standard_normal((b, h, sg, d)).astype(np.float32)
              for _ in range(2))
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    want, vjp = jax.vjp(lambda *a: _jax_local_global(*a, window),
                        *map(jnp.asarray, (q, k, v, gk, gv)))
    want_grads = vjp(jnp.asarray(do))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, gk, gv)]
    before = (tswa.swa_local_global_fwd.launches,
              tswa.swa_local_global_fwd.launches_sm90)
    got = tswa.swa_local_global(*ts, window)
    assert (tswa.swa_local_global_fwd.launches,  # CPU: plain version
            tswa.swa_local_global_fwd.launches_sm90) == before
    _close(got, want, ATTN_TOL)
    got.backward(torch.from_numpy(do))
    for t, w in zip(ts, want_grads):
        _close(t.grad, w, GRAD_TOL)


def test_swa_local_global_plain_is_band_plus_global(rng):
    """The plain version on pre-scaled q is the banded plain softmax plus
    the dense plain softmax over the global set."""
    qf, kf, vf = (torch.from_numpy(rng.standard_normal((3, 150, 32))
                                   .astype(np.float32)) for _ in range(3))
    gk, gv = (torch.from_numpy(rng.standard_normal((3, 20, 32))
                               .astype(np.float32)) for _ in range(2))
    got = tswa.swa_local_global_fwd(qf, kf, vf, gk, gv, 20)
    local, _ = tswa.sliding_window_plain(qf, kf, vf, 20)
    glob, _ = tswa.flash_attention_plain(qf, gk, gv)
    _close(got, (local + glob).numpy(), 1e-6)
    with pytest.raises(ValueError):
        tswa.swa_local_global_fwd(qf, kf, vf, gk, gv, -1)


def _streams(rng, nh, f, h, w, st):
    b, d = 1, 8
    sv = f * h * w
    return [rng.standard_normal((b, nh, n, d)).astype(np.float32)
            for n in (st, st, st, sv, sv, sv)]


@pytest.mark.parametrize("nh,f,h,w,st,cross_size", STREAM_SHAPES)
def test_swa_streams_fused_match_jax(rng, nh, f, h, w, st, cross_size):
    """fuse_cross=True against JAX's fused path (K5 in interpret mode), and
    against the port's own unfused path: the same function."""
    arrs = _streams(rng, nh, f, h, w, st)
    kw = dict(num_frames=f, height=h, width=w,
              cross_attention_size=cross_size)
    want = jswa.swa_attention_streams(*map(jnp.asarray, arrs),
                                      impl="pallas_interpret",
                                      fuse_cross=True, **kw)
    got = tswa.swa_attention_streams(*map(torch.from_numpy, arrs),
                                     fuse_cross=True, **kw)
    unfused = tswa.swa_attention_streams(*map(torch.from_numpy, arrs), **kw)
    for g, wnt, u in zip(got, want, unfused):
        _close(g, wnt, ATTN_TOL)
        _close(g, u.numpy(), 1e-5)

    joint = tswa.swa_joint_attention(
        *(torch.cat([torch.from_numpy(arrs[i]), torch.from_numpy(arrs[i + 3])],
                    dim=2) for i in range(3)),
        text_len=st, fuse_cross=True, **kw)
    _close(joint, torch.cat(got, dim=2).numpy(), 1e-6)


@pytest.mark.parametrize("nh,f,h,w,st,cross_size", STREAM_SHAPES)
def test_swa_streams_fused_grads_match_jax(rng, nh, f, h, w, st, cross_size):
    """Gradients of the text and video q, k, v through the fused streams
    against jax.vjp of JAX's fused path, from the same cotangents."""
    arrs = _streams(rng, nh, f, h, w, st)
    kw = dict(num_frames=f, height=h, width=w,
              cross_attention_size=cross_size)
    d_txt = rng.standard_normal(arrs[0].shape).astype(np.float32)
    d_vid = rng.standard_normal(arrs[3].shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda *a: jswa.swa_attention_streams(*a, impl="pallas_interpret",
                                              fuse_cross=True, **kw),
        *map(jnp.asarray, arrs))
    want = vjp((jnp.asarray(d_txt), jnp.asarray(d_vid)))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    out_t, out_v = tswa.swa_attention_streams(*ts, fuse_cross=True, **kw)
    torch.autograd.backward((out_t, out_v),
                            (torch.from_numpy(d_txt), torch.from_numpy(d_vid)))
    for t, w_ in zip(ts, want):
        _close(t.grad, w_, GRAD_TOL)
