"""Sliding-window attention (SWA) for the V5.1 `swa_layers`: the banded
kernel (csrc/swa_fwd.cu, K2), the fused local + global kernel
(csrc/swa_fused_fwd.cu, K5), their plain PyTorch versions, and the
6-direction composition.

Parity target: easyanimate_tpu/ops/swa.py (reference
EasyAnimateSWAttnProcessor2_0, processor.py:320-459):
  - a global "cross" pass: every query attends to the text tokens plus a
    strided subset of the video tokens (about cross_attention_size in all);
  - a local pass: heads split into 6 groups as torch.tensor_split does, each
    group seeing the video tokens in its own (f, h, w) axis order, with
    attention banded to |i - j| <= window (window = tokens per frame);
  - video out = local + cross; text out = 2 x cross (the reference adds
    the cross output to the concat -- kept verbatim).
Under a sequence-parallel scope (parallel/context.py) the streams run
Ulysses-style (JAX swa.py:807-905): the video tokens' slices become head
slices over all tokens (an all-to-all), the cross pass and the 6-direction
local pass run on the rank's heads -- each head in the direction group of
its GLOBAL index -- and a second all-to-all brings the video output back to
token slices (the text output's heads are all-gathered). The banded pass
is differentiable: its backward is K6 (dq) and K7 (dk, dv),
csrc/swa_bwd.cu (both TMA + wgmma kernels at d 64). With fuse_cross=True
(off by default, as in JAX) the video queries' cross pass runs inside K5
(a TMA + wgmma kernel at d 64 too), whose backward recomputes through the
unfused pair (K2 + K6/K7 for the band, K1 + K3/K4 for the global set).
"""
from typing import Optional, Tuple

import torch

from . import _build
from .attention import attention, prescale
from .flash_attention import (LN2, flash_attention_bwd, flash_attention_fwd,
                              flash_attention_plain, row_dot)

Pair = Tuple[torch.Tensor, torch.Tensor]
Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_AXIS_ORDERS = (
    None,            # group 0: native (f, h, w)
    (0, 2, 1),       # (f, w, h)
    (1, 0, 2),       # (h, f, w)
    (1, 2, 0),       # (h, w, f)
    (2, 0, 1),       # (w, f, h)
    (2, 1, 0),       # (w, h, f)
)


def sliding_window_plain(qf: torch.Tensor, kf: torch.Tensor,
                         vf: torch.Tensor, window: int,
                         block_q: int = 512) -> Pair:
    """K2's plain version, the banded form of swa_reference_banded
    (easyanimate_tpu/ops/swa.py:651): per q block, one float32 base-2
    softmax over the kv span [q0 - window, q0 + block_q + window) that the
    block can see, masked to |i - j| <= window. O(S * window) memory.
    q is pre-scaled; returns (o, lse2 [bh, S, 1])."""
    bh, n, d = qf.shape
    bq = min(block_q, n)
    span = min(n, bq + 2 * window)
    o = torch.empty_like(qf)
    lse = torch.empty((bh, n, 1), dtype=torch.float32, device=qf.device)
    for i0 in range(0, n, bq):
        rows = min(bq, n - i0)
        s0 = min(max(i0 - window, 0), n - span)
        kk = kf[:, s0:s0 + span].float()
        vv = vf[:, s0:s0 + span].float()
        s = torch.matmul(qf[:, i0:i0 + rows].float(), kk.transpose(1, 2))
        qi = torch.arange(i0, i0 + rows, device=qf.device)
        kj = torch.arange(s0, s0 + span, device=qf.device)
        band = (qi[:, None] - kj[None, :]).abs() <= window
        s = s.masked_fill(~band, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o[:, i0:i0 + rows] = (torch.matmul(p, vv) / l).to(o.dtype)
        lse[:, i0:i0 + rows] = m + torch.log2(l)
    return o, lse


def sliding_window_fwd(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                       window: int) -> Pair:
    """Banded attention |i - j| <= window over pre-scaled q and k, v
    [bh, S, d] -> (o, lse2 [bh, S, 1] float32).

    A CUDA tensor launches K2 (bf16, d in 16/32/64, contiguous) or raises; a
    CPU tensor takes sliding_window_plain. `sliding_window_fwd.launches`
    counts kernel launches, `.launches_sm90` those that ran the TMA + wgmma
    kernel (d 64; d 16 and 32 run the mma.sync one)."""
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if qf.device.type == "cpu":
        return sliding_window_plain(qf, kf, vf, window)
    _build.check_kernel_inputs(qf, kf, vf, kernel=_build.K2)
    if not qf.shape == kf.shape == vf.shape:
        raise ValueError(f"shapes q {tuple(qf.shape)} k {tuple(kf.shape)} "
                         f"v {tuple(vf.shape)}")
    bh, n, d = qf.shape
    o = torch.empty_like(qf)
    lse = torch.empty((bh, n, 1), dtype=torch.float32, device=qf.device)
    _build.launch("ea_swa_fwd_bf16", qf.device, qf.data_ptr(), kf.data_ptr(),
                  vf.data_ptr(), o.data_ptr(), lse.data_ptr(), bh, n, window,
                  d)
    sliding_window_fwd.launches += 1
    sliding_window_fwd.launches_sm90 += _build.load_library(
        ).ea_swa_fwd_uses_sm90(d)
    return o, lse


sliding_window_fwd.launches = 0
sliding_window_fwd.launches_sm90 = 0


def sliding_window_bwd_plain(qf: torch.Tensor, kf: torch.Tensor,
                             vf: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, window: int,
                             block_q: int = 512) -> Triple:
    """K6 + K7's plain version: per q block, p = exp2(q k^T - lse2)
    recomputed in float32 over the kv span the block can see (as
    sliding_window_plain), zero outside |i - j| <= window. O(S * window)
    memory. Returns (dq, dk, dv) with respect to the pre-scaled q."""
    n = qf.shape[1]
    bq = min(block_q, n)
    span = min(n, bq + 2 * window)
    di = row_dot(o, do)
    dq = torch.empty_like(qf)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=kf.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=vf.device)
    for i0 in range(0, n, bq):
        rows = min(bq, n - i0)
        s0 = min(max(i0 - window, 0), n - span)
        kk = kf[:, s0:s0 + span].float()
        vv = vf[:, s0:s0 + span].float()
        q32 = qf[:, i0:i0 + rows].float()
        do32 = do[:, i0:i0 + rows].float()
        qi = torch.arange(i0, i0 + rows, device=qf.device)
        kj = torch.arange(s0, s0 + span, device=qf.device)
        band = (qi[:, None] - kj[None, :]).abs() <= window
        p = torch.where(band, torch.exp2(torch.matmul(q32, kk.transpose(1, 2))
                                         - lse[:, i0:i0 + rows]), 0.0)
        ds = p * (torch.matmul(do32, vv.transpose(1, 2)) - di[:, i0:i0 + rows])
        dq[:, i0:i0 + rows] = (torch.matmul(ds, kk) * LN2).to(dq.dtype)
        dk[:, s0:s0 + span] += torch.matmul(ds.transpose(1, 2), q32)
        dv[:, s0:s0 + span] += torch.matmul(p.transpose(1, 2), do32)
    return dq, (dk * LN2).to(kf.dtype), dv.to(vf.dtype)


def sliding_window_bwd(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                       o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                       window: int) -> Triple:
    """Gradients (dq, dk, dv) of sliding_window_fwd's o from its residuals
    and the cotangent do [bh, S, d].

    A CUDA tensor launches K6 (dq) then K7 (dk, dv), or raises (contiguous
    bf16 inputs, float32 lse); a CPU tensor takes sliding_window_bwd_plain.
    `sliding_window_bwd.launches` counts calls that launched the pair,
    `.launches_sm90` those in which both ran their TMA + wgmma kernels (d
    64; d 16 and 32 run the mma.sync ones)."""
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if qf.device.type == "cpu":
        return sliding_window_bwd_plain(qf, kf, vf, o, lse, do, window)
    _build.check_kernel_inputs(qf, kf, vf, o, do, kernel=_build.K6_K7)
    _build.check_row_stats(lse, qf)
    if not qf.shape == kf.shape == vf.shape == o.shape == do.shape:
        raise ValueError(f"shapes q {tuple(qf.shape)} k {tuple(kf.shape)} "
                         f"v {tuple(vf.shape)} o {tuple(o.shape)} "
                         f"do {tuple(do.shape)}")
    bh, n, d = qf.shape
    di = row_dot(o, do)
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)
    ptrs = [x.data_ptr() for x in (qf, kf, vf, do, lse, di)]
    _build.launch("ea_swa_bwd_dq_bf16", qf.device, *ptrs, dq.data_ptr(), bh,
                  n, window, d)
    _build.launch("ea_swa_bwd_dkv_bf16", qf.device, *ptrs, dk.data_ptr(),
                  dv.data_ptr(), bh, n, window, d)
    sliding_window_bwd.launches += 1
    lib = _build.load_library()
    sliding_window_bwd.launches_sm90 += (lib.ea_swa_bwd_dq_uses_sm90(d)
                                         and lib.ea_swa_bwd_dkv_uses_sm90(d))
    return dq, dk, dv


sliding_window_bwd.launches = 0
sliding_window_bwd.launches_sm90 = 0


class SlidingWindowAttention(torch.autograd.Function):
    """Banded attention over pre-scaled q, differentiable: forward
    sliding_window_fwd (K2), backward sliding_window_bwd (K6 + K7) -- the
    port of the JAX custom_vjp at easyanimate_tpu/ops/swa.py:566-592."""

    @staticmethod
    def forward(ctx, qf, kf, vf, window):
        o, lse = sliding_window_fwd(qf, kf, vf, window)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, o, lse = ctx.saved_tensors
        dq, dk, dv = sliding_window_bwd(qf, kf, vf, o, lse, do.contiguous(),
                                        ctx.window)
        return dq, dk, dv, None


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int,
                             sm_scale: Optional[float] = None) -> torch.Tensor:
    """Bidirectional +-window attention over [B, H, S, D], differentiable
    (the sm_scale fold stays outside the autograd Function, as in JAX)."""
    b, h, s, d = q.shape
    if sm_scale is None:
        sm_scale = d ** -0.5
    qf = prescale(q, sm_scale).reshape(b * h, s, d).contiguous()
    o = SlidingWindowAttention.apply(
        qf, k.reshape(b * h, s, d).contiguous(),
        v.reshape(b * h, s, d).contiguous(), window)
    return o.reshape(b, h, s, d)


def swa_local_global_plain(qf: torch.Tensor, kf: torch.Tensor,
                           vf: torch.Tensor, gk: torch.Tensor,
                           gv: torch.Tensor, window: int) -> torch.Tensor:
    """K5's plain version: the float32 banded softmax of sliding_window_plain
    over (kf, vf) plus the float32 dense softmax of flash_attention_plain
    over the global set (gk, gv) [bh, Sg, d], each normalised, summed, and
    rounded once to q's dtype. q is pre-scaled."""
    f32 = [x.float() for x in (qf, kf, vf, gk, gv)]
    local, _ = sliding_window_plain(*f32[:3], window)
    glob, _ = flash_attention_plain(f32[0], f32[3], f32[4])
    return (local + glob).to(qf.dtype)


def swa_local_global_fwd(qf: torch.Tensor, kf: torch.Tensor,
                         vf: torch.Tensor, gk: torch.Tensor,
                         gv: torch.Tensor, window: int) -> torch.Tensor:
    """Banded attention |i - j| <= window over (kf, vf) [bh, S, d] plus an
    independent dense softmax over the global kv (gk, gv) [bh, Sg, d], for
    pre-scaled q [bh, S, d] -> o [bh, S, d]. No lse: the backward
    recomputes through the unfused pair.

    A CUDA tensor launches K5 (bf16, d in 16/32/64, contiguous) or raises; a
    CPU tensor takes swa_local_global_plain. `swa_local_global_fwd.launches`
    counts kernel launches, `.launches_sm90` those that ran the TMA + wgmma
    kernel (d 64; d 16 and 32 run the mma.sync one)."""
    if window < 0:
        raise ValueError(f"window {window} < 0")
    if qf.device.type == "cpu":
        return swa_local_global_plain(qf, kf, vf, gk, gv, window)
    _build.check_kernel_inputs(qf, kf, vf, gk, gv, kernel=_build.K5)
    bh, n, d = qf.shape
    if (not qf.shape == kf.shape == vf.shape or gk.shape != gv.shape
            or gk.shape[0] != bh or gk.shape[2] != d or gk.shape[1] < 1):
        raise ValueError(f"shapes q {tuple(qf.shape)} k {tuple(kf.shape)} "
                         f"v {tuple(vf.shape)} gk {tuple(gk.shape)} "
                         f"gv {tuple(gv.shape)}")
    o = torch.empty_like(qf)
    _build.launch("ea_swa_fused_fwd_bf16", qf.device, qf.data_ptr(),
                  kf.data_ptr(), vf.data_ptr(), gk.data_ptr(), gv.data_ptr(),
                  o.data_ptr(), bh, n, gk.shape[1], window, d)
    swa_local_global_fwd.launches += 1
    swa_local_global_fwd.launches_sm90 += _build.load_library(
        ).ea_swa_fused_fwd_uses_sm90(d)
    return o


swa_local_global_fwd.launches = 0
swa_local_global_fwd.launches_sm90 = 0


class SwaLocalGlobal(torch.autograd.Function):
    """Banded + global attention over pre-scaled q, differentiable: forward
    swa_local_global_fwd (K5); backward as the JAX custom_vjp's
    (easyanimate_tpu/ops/swa.py:360-376), through the unfused pair --
    sliding_window_fwd + sliding_window_bwd (K2, K6 + K7) for the band,
    flash_attention_fwd + flash_attention_bwd (K1, K3 + K4) for the global
    set. The forward keeps no lse, so the backward recomputes both."""

    @staticmethod
    def forward(ctx, qf, kf, vf, gk, gv, window):
        o = swa_local_global_fwd(qf, kf, vf, gk, gv, window)
        ctx.save_for_backward(qf, kf, vf, gk, gv)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, gk, gv = ctx.saved_tensors
        do = do.contiguous()
        o1, lse1 = sliding_window_fwd(qf, kf, vf, ctx.window)
        dq1, dk, dv = sliding_window_bwd(qf, kf, vf, o1, lse1, do, ctx.window)
        o2, lse2 = flash_attention_fwd(qf, gk, gv)
        dq2, dgk, dgv = flash_attention_bwd(qf, gk, gv, o2, lse2, do)
        dq = (dq1.float() + dq2.float()).to(qf.dtype)
        return dq, dk, dv, dgk, dgv, None


def swa_local_global(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     gk: torch.Tensor, gv: torch.Tensor,
                     window: int) -> torch.Tensor:
    """Windowed local attention over (k, v) [B, H, S, D] PLUS the
    independent global softmax over (gk, gv) [B, H, Sg, D], summed
    (reference processor.py:436), differentiable; the port of JAX
    swa_local_global (easyanimate_tpu/ops/swa.py:280). The D ** -0.5 fold
    stays outside the autograd Function."""
    b, h, s, d = q.shape
    sg = gk.shape[2]
    flat = lambda x, n: x.reshape(b * h, n, d).contiguous()
    o = SwaLocalGlobal.apply(flat(prescale(q, d ** -0.5), s), flat(k, s),
                             flat(v, s), flat(gk, sg), flat(gv, sg), window)
    return o.reshape(b, h, s, d)


def _permute_tokens(x: torch.Tensor, f: int, h: int, w: int, order,
                    inverse: bool = False) -> torch.Tensor:
    """x [B, Hd, f*h*w, D] -> tokens reordered by the (f, h, w) axis
    permutation `order` (or back, with inverse=True)."""
    if order is None:
        return x
    b, nh, s, d = x.shape
    sizes = (f, h, w)
    if not inverse:
        grid = x.reshape(b, nh, f, h, w, d)
        grid = grid.permute(0, 1, *(2 + a for a in order), 5)
    else:
        grid = x.reshape(b, nh, *(sizes[a] for a in order), d)
        inv = [order.index(a) for a in range(3)]
        grid = grid.permute(0, 1, *(2 + p for p in inv), 5)
    return grid.reshape(b, nh, s, d)


def _direction_groups(num_heads: int, start: int, count: int):
    """(slice of the local heads, axis order) of each direction group met
    by heads [start, start + count) of num_heads: groups as
    torch.tensor_split(heads, 6) makes them (the first num_heads % 6 carry
    the extra head), over the GLOBAL head index, so a rank's head slice
    keeps its heads' groups (JAX swa.py:880-885)."""
    base, rem = divmod(num_heads, len(_AXIS_ORDERS))
    out, lo = [], 0
    for g, order in enumerate(_AXIS_ORDERS):
        hi = lo + base + (1 if g < rem else 0)
        a, b = max(lo, start), min(hi, start + count)
        if a < b:
            out.append((slice(a - start, b - start), order))
        lo = hi
    return out


def swa_attention_streams(q_txt, k_txt, v_txt, q_vid, k_vid, v_vid, *,
                          num_frames: int, height: int, width: int,
                          cross_attention_size: int = 1024,
                          fuse_cross: bool = False):
    """SWA over separate (text, video) streams [B, H, St|Sv, D] ->
    (out_text, out_vid). window = height * width.

    fuse_cross=True runs the video queries' cross pass inside the local
    kernel (swa_local_global, K5) and only the text queries' cross pass as
    its own attention call; the result is the same function. Under a
    sequence-parallel scope the video tensors are the rank's token slice,
    the text every rank's, and the Ulysses form runs (fuse_cross off, as
    JAX swa.py:844)."""
    from ..parallel.context import current_sp

    scope = current_sp()
    kw = dict(num_frames=num_frames, height=height, width=width,
              cross_attention_size=cross_attention_size)
    if scope is None:
        return swa_streams_heads(q_txt, k_txt, v_txt, q_vid, k_vid, v_vid,
                                 fuse_cross=fuse_cross, **kw)
    return _ulysses_streams(scope, q_txt, k_txt, v_txt, q_vid, k_vid, v_vid,
                            **kw)


def _ulysses_streams(scope, q_txt, k_txt, v_txt, q_vid, k_vid, v_vid, **kw):
    """The streams over the rank's heads and all tokens: video token
    slices -> head slices (all-to-all), both passes, and back
    (parallel/context.py's to_heads / from_heads, as head_parallel_call).
    When sp does not divide the heads every rank gathers the video
    tokens, runs all heads and keeps its token slice."""
    from ..parallel import context as ctx

    nh = q_txt.shape[1]
    heads, vid = ctx.to_heads(scope, nh, (q_vid, k_vid, v_vid))
    txt = (q_txt, k_txt, v_txt)
    if heads is None:
        o_t, o_v = swa_streams_heads(*txt, *vid, **kw)
    else:
        o_t, o_v = swa_streams_heads(*(x[:, heads] for x in txt), *vid,
                                     head_start=heads.start, num_heads=nh,
                                     **kw)
        o_t = ctx.allgather(o_t, 1, scope)
    return o_t, ctx.from_heads(scope, heads, o_v)


def swa_streams_heads(q_txt, k_txt, v_txt, q_vid, k_vid, v_vid, *,
                      num_frames: int, height: int, width: int,
                      cross_attention_size: int = 1024,
                      fuse_cross: bool = False, head_start: int = 0,
                      num_heads: Optional[int] = None):
    """swa_attention_streams on one device, over heads [head_start,
    head_start + H) of num_heads (all of them by default): the body one sp
    rank runs on its head slice in the Ulysses form."""
    st = q_txt.shape[2]
    sv = q_vid.shape[2]
    window = height * width
    groups = _direction_groups(num_heads or q_txt.shape[1], head_start,
                               q_txt.shape[1])

    # global cross pass: every query against text + strided video kv
    interval = max(sv // max(cross_attention_size - st, 1), 1)
    ck = torch.cat([k_txt, k_vid[:, :, ::interval]], dim=2)
    cv = torch.cat([v_txt, v_vid[:, :, ::interval]], dim=2)
    if fuse_cross:
        cross_txt, cross_vid = attention(q_txt, ck, cv), None
    else:
        cross = attention(torch.cat([q_txt, q_vid], dim=2), ck, cv)
        cross_txt, cross_vid = cross[:, :, :st], cross[:, :, st:]

    # local pass: the 6 head groups share one window, so their permuted
    # tokens batch into one kernel call over all heads
    def permuted(x):
        return torch.cat([
            _permute_tokens(x[:, sl], num_frames, height, width, order)
            for sl, order in groups], dim=1)

    qq, kk, vv = permuted(q_vid), permuted(k_vid), permuted(v_vid)
    if fuse_cross:
        # the group concat keeps the head order, so the unpermuted global kv
        # lines up per head; the global softmax does not depend on the
        # token order, so inverse-permuting the kernel's sum gives
        # local + cross
        oo = swa_local_global(qq, kk, vv, ck, cv, window)
    else:
        oo = sliding_window_attention(qq, kk, vv, window=window)
    local = torch.cat([
        _permute_tokens(oo[:, sl], num_frames, height, width, order,
                        inverse=True)
        for sl, order in groups], dim=1)
    # reference: video = local + cross_video; text = 2 x cross_text
    if cross_vid is None:
        return cross_txt * 2.0, local
    return cross_txt * 2.0, local + cross_vid


def swa_joint_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        text_len: int, num_frames: int, height: int,
                        width: int, cross_attention_size: int = 1024,
                        fuse_cross: bool = False) -> torch.Tensor:
    """SWA over joint (text, video) tokens [B, H, S, D] -> the same shape;
    the concat-input form of swa_attention_streams."""
    out_text, out_vid = swa_attention_streams(
        q[:, :, :text_len], k[:, :, :text_len], v[:, :, :text_len],
        q[:, :, text_len:], k[:, :, text_len:], v[:, :, text_len:],
        num_frames=num_frames, height=height, width=width,
        cross_attention_size=cross_attention_size, fuse_cross=fuse_cross)
    return torch.cat([out_text, out_vid], dim=2)
