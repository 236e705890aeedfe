"""Sequence (context) parallel attention over the mesh's `sp` axis.

Parity: easyanimate_tpu/parallel/context.py. Each sp rank holds a
contiguous 1/sp slice of the video tokens (models/mmdit.py cuts it after
the patchify) and the whole text stream; attention runs across the
slices three ways:
  - all-gather ("allgather", training): k and v of the video slices are
    all-gathered, then K1 runs on the local q (K3 + K4 in the backward,
    then a reduce-scatter of dk and dv);
  - ring ("ring"): the kv slices rotate around the sp ranks
    (batch_isend_irecv, the next block's transfer issued before the local
    K1); each hop's o and base-2 lse merge in float32. The backward runs
    K3 + K4 per hop from the global lse and o, and rotates (k, v, dk, dv)
    together until every dk and dv is home;
  - Ulysses (the SWA layers, ops/swa.py): an all-to-all turns the token
    slices into head slices over all tokens, the windowed kernels run on
    the rank's heads, and a second all-to-all turns them back.
Replicated columns (the text's k and v) are counted once: they join the
attention on every rank as a block of their own, never gathered or
rotated. The text rows of an attention output are made bit-identical on
every rank (sp rank 0's copy broadcast), so the replicated text stream
cannot drift apart.

Gradients: every collective here is differentiated by its adjoint
(all-gather by reduce-scatter, a slice by zero padding, the ring by its
own backward), so each rank's backward carries the gradient of the paths
that end in its own video tokens; a parameter's gradient is the sum over
the sp ranks (parallel/sharding.py). gather_tokens, after the model's
proj_out, is the one exception: what follows it (unpatchify, the loss,
the sampler step) runs identically on every rank and holds no parameter,
so its backward keeps the rank's own rows.

Hop bodies (ring_fwd_hop, ring_merge, ring_bwd_hop) live at module level
so that a single process can run the ring's arithmetic over shards
(chip_smoke.py's `parallel` phase on one card).
"""
import contextlib
import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.attention import attention, prescale
from ..ops.flash_attention import (flash_attention_bwd, flash_attention_fwd,
                                   row_dot)
from .mesh import Mesh

MODES = ("allgather", "ring")

# -- the ambient scope -------------------------------------------------------
#
# Process-wide, not per thread as JAX's: on the card autograd runs the
# backward -- and with it a remat block's recompute, which must take the
# same sequence-parallel path as its forward -- on its own device thread.

_SP_SCOPE = {"scope": None}


@dataclasses.dataclass(frozen=True)
class SPScope:
    mesh: Mesh
    mode: str = "allgather"  # 'allgather' (training) | 'ring'

    @property
    def group(self):
        return self.mesh.group("sp")

    @property
    def size(self) -> int:
        return self.mesh.shape["sp"]

    @property
    def rank(self) -> int:
        return self.mesh.rank("sp")


def active_scope() -> Optional[SPScope]:
    """The scope as entered, whatever its sp size."""
    return _SP_SCOPE["scope"]


def current_sp() -> Optional[SPScope]:
    """The active scope, or None when there is none or its sp is 1."""
    scope = active_scope()
    if scope is None or scope.size <= 1:
        return None
    return scope


@contextlib.contextmanager
def sequence_parallel(mesh: Mesh, mode: str = "allgather"):
    """Shard the video tokens of the models run inside this block over
    the mesh's sp ranks, and run their attention across the shards."""
    if mode not in MODES:
        raise ValueError(f"sequence_parallel mode {mode!r}: one of {MODES}")
    prev = active_scope()
    _SP_SCOPE["scope"] = SPScope(mesh=mesh, mode=mode)
    try:
        yield
    finally:
        _SP_SCOPE["scope"] = prev


def check_serving_mesh() -> None:
    """A pipeline under a scope whose mesh has dp > 1 (the CFG pair split
    over ranks) raises: not ported."""
    scope = active_scope()
    if scope is not None and scope.mesh.shape["dp"] > 1:
        raise NotImplementedError(
            f"dp={scope.mesh.shape['dp']} inside the serving pipeline is not "
            "ported (ROADMAP queue 1 item 10: multi-GPU); serve on a dp=1 "
            "mesh (sp shards one request's tokens)")


# -- collectives with their adjoints -----------------------------------------


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's equal-sized x concatenated along dim."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along dim of the sum of every rank's x."""
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
    dist.reduce_scatter_tensor(out, xt, group=group)
    return out.movedim(0, dim)


def _own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over sp={n}")
    size = x.shape[dim] // n
    return x.narrow(dim, r * size, size)


class _Split(torch.autograd.Function):
    """This rank's slice of a tensor every rank holds; backward: the
    slice's gradient in place, zeros elsewhere."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.shape = dim, group, x.shape
        return _own_slice(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        out = g.new_zeros(ctx.shape)
        _own_slice(out, ctx.dim, ctx.group).copy_(g)
        return out, None, None


class _Gather(torch.autograd.Function):
    """All-gather along dim; backward: reduce-scatter (the sum of every
    rank's gradient of the gathered tensor, this rank's slice)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _GatherToReplicated(torch.autograd.Function):
    """All-gather along dim into a tensor that every rank then uses the
    same way; backward: the rank's own slice of the (identical) gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _own_slice(g, ctx.dim, ctx.group).contiguous(), None, None


class _SyncReplicated(torch.autograd.Function):
    """sp rank 0's copy of a tensor every rank computed alike (bit-equal
    replicas whatever the rounding); backward: identity."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.broadcast(y, src=dist.get_global_rank(group, 0), group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_tokens(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """The token slices of every sp rank, concatenated along dim, for work
    that every rank then does alike (the model's head, the loss);
    identity without an sp scope."""
    scope = current_sp()
    return (x if scope is None
            else _GatherToReplicated.apply(x, dim, scope.group))


def sp_constraint(x: torch.Tensor, spec_axes) -> torch.Tensor:
    """JAX's sp_constraint in explicit SPMD: a tensor that is the same on
    every rank becomes this rank's contiguous slice of the dim that
    `spec_axes` (a mesh-axis name or None per dim) puts on 'sp' (backward:
    the slice's gradient in place, zeros elsewhere). 'dp' needs no cut
    (each dp rank already holds its own rows). No scope, or no 'sp': x."""
    scope = current_sp()
    if scope is None or "sp" not in spec_axes:
        return x
    return _Split.apply(x, list(spec_axes).index("sp"), scope.group)


# -- ring hops ----------------------------------------------------------------


def ring_fwd_hop(qf, kf, vf) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop: K1 on the local pre-scaled q [bh, Sq, d] against a kv block
    [bh, Skv, d] -> (o, lse2 [bh, Sq, 1] float32). The token slices are
    equal (the split checks that sp divides the tokens), so no block is
    padded and no kv_valid is needed."""
    return flash_attention_fwd(qf, kf, vf)


def ring_merge(o_acc: torch.Tensor, lse_acc: torch.Tensor, o: torch.Tensor,
               lse: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a hop's (o, lse2) into the float32 accumulators (o_acc, lse_acc
    start at 0 and -inf): lse_new = logaddexp2(lse_acc, lse), o_acc =
    o_acc 2^(lse_acc - lse_new) + o 2^(lse - lse_new). In place."""
    lse_new = torch.logaddexp2(lse_acc, lse)
    o_acc.mul_(torch.exp2(lse_acc - lse_new)).add_(
        o.float() * torch.exp2(lse - lse_new))
    return o_acc, lse_new


def ring_bwd_hop(qf, kf, vf, o, lse, do, di=None):
    """One backward hop: K3 + K4 on the local q against a kv block, from
    the GLOBAL o and lse2 (and di = rowsum(o * do), taken once per call)
    -> (dq, dk, dv) of this block's contribution."""
    return flash_attention_bwd(qf, kf, vf, o, lse, do, di=di)


def _rotate(tensors, group):
    """Send `tensors` (stacked) to the next sp rank and receive the
    previous rank's; returns (requests, receive buffer)."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    send = torch.stack(tensors)
    recv = torch.empty_like(send)
    nxt = dist.get_global_rank(group, (r + 1) % n)
    prv = dist.get_global_rank(group, (r - 1) % n)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, nxt, group),
                                   dist.P2POp(dist.irecv, recv, prv, group)])
    return reqs, recv


def _wait(reqs):
    for req in reqs:
        req.wait()


def ring_forward(qf, kf, vf, kr, vr, group):
    """-> (o [bh, Sq, d] in q's dtype, lse2 [bh, Sq, 1] float32): q against
    the replicated block (kr, vr; may be None) and every rank's (kf, vf)."""
    n = dist.get_world_size(group)
    o_acc = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
    lse_acc = torch.full((*qf.shape[:2], 1), -torch.inf, device=qf.device)
    if kr is not None:
        o_acc, lse_acc = ring_merge(o_acc, lse_acc, *ring_fwd_hop(qf, kr, vr))
    kb, vb = kf, vf
    for i in range(n):
        reqs = None
        if i < n - 1:  # the next block's transfer overlaps this hop's K1
            reqs, recv = _rotate((kb, vb), group)
        o_acc, lse_acc = ring_merge(o_acc, lse_acc, *ring_fwd_hop(qf, kb, vb))
        if reqs is not None:
            _wait(reqs)
            kb, vb = recv[0], recv[1]
    return o_acc.to(qf.dtype), lse_acc


def ring_backward(qf, kf, vf, kr, vr, o, lse, do, group):
    """Gradients of ring_forward's o: (dq, dk, dv, dkr, dvr) with respect
    to the pre-scaled q, this rank's kv block and the replicated block."""
    n = dist.get_world_size(group)
    di = row_dot(o, do)
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
    dkr = dvr = None
    if kr is not None:
        dqh, dkr, dvr = ring_bwd_hop(qf, kr, vr, o, lse, do, di)
        dq += dqh.float()
    kb, vb = kf, vf
    dkb = torch.zeros(kf.shape, dtype=torch.float32, device=kf.device)
    dvb = torch.zeros_like(dkb)
    for i in range(n):
        reqs = None
        if i < n - 1:
            reqs, recv = _rotate((kb, vb), group)
        dqh, dkh, dvh = ring_bwd_hop(qf, kb, vb, o, lse, do, di)
        dq += dqh.float()
        dkb += dkh.float()
        dvb += dvh.float()
        if reqs is not None:
            _wait(reqs)
            kb, vb = recv[0], recv[1]
        if n > 1:  # the accumulators travel with their block: n moves, home
            g_reqs, g_recv = _rotate((dkb, dvb), group)
            _wait(g_reqs)
            dkb, dvb = g_recv[0], g_recv[1]
    return (dq.to(qf.dtype), dkb.to(kf.dtype), dvb.to(vf.dtype), dkr, dvr)


class RingAttention(torch.autograd.Function):
    """o = softmax attention of pre-scaled q over the replicated block and
    the ring of kv blocks; forward ring_forward (K1 per hop), backward
    ring_backward (K3 + K4 per hop). The port of JAX's
    ring_attention_diff (context.py:246-266)."""

    @staticmethod
    def forward(ctx, qf, kf, vf, kr, vr, group):
        o, lse = ring_forward(qf, kf, vf, kr, vr, group)
        ctx.save_for_backward(qf, kf, vf, kr, vr, o, lse)
        ctx.group = group
        return o

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, kr, vr, o, lse = ctx.saved_tensors
        dq, dk, dv, dkr, dvr = ring_backward(qf, kf, vf, kr, vr, o, lse,
                                             do.contiguous(), ctx.group)
        return dq, dk, dv, dkr, dvr, None


# -- sequence-parallel attention ------------------------------------------------


def _sync_rows(o: torch.Tensor, rows: int, group) -> torch.Tensor:
    """o [B, H, S, D] with its first `rows` rows sp rank 0's."""
    if not rows:
        return o
    return torch.cat([_SyncReplicated.apply(o[:, :, :rows], group),
                      o[:, :, rows:]], dim=2)


def allgather_kv_attention(q, k, v, group, replicated: int = 0):
    """Local q [B, H, Sq, D] over the kv of every sp rank: the first
    `replicated` rows of k and v are the same on every rank (taken once),
    the rest are this rank's token slice (all-gathered)."""
    k_all = _Gather.apply(k[:, :, replicated:], 2, group)
    v_all = _Gather.apply(v[:, :, replicated:], 2, group)
    if replicated:
        k_all = torch.cat([k[:, :, :replicated], k_all], dim=2)
        v_all = torch.cat([v[:, :, :replicated], v_all], dim=2)
    return attention(q, k_all, v_all)


def ring_attention(q, k, v, group, replicated: int = 0):
    """allgather_kv_attention's function by the ring: [B, H, S, D], scale
    D ** -0.5 folded into q outside the Function (as ops/attention.py)."""
    b, h, sq, d = q.shape
    flat = lambda x: x.reshape(b * h, x.shape[2], d).contiguous()
    kr = vr = None
    if replicated:
        kr, vr = flat(k[:, :, :replicated]), flat(v[:, :, :replicated])
    o = RingAttention.apply(flat(prescale(q, d ** -0.5)),
                            flat(k[:, :, replicated:]),
                            flat(v[:, :, replicated:]), kr, vr, group)
    return o.reshape(b, h, sq, d)


def make_sp_attention(mesh: Mesh, mode: str = "allgather",
                      shape=None) -> Callable:
    """fn(q, k, v, replicated=0) over this rank's [B, H, S_local, D]
    (the batch is the rank's dp rows; heads whole, tp is 1): the first
    `replicated` rows of q, k and v are the same on every sp rank (the
    text), the rest the rank's token slice. Their output rows come back
    bit-identical on every rank. `shape`, the global (B, H, S, D), is
    checked: S must divide by sp."""
    sp = mesh.shape["sp"]
    if shape is not None and shape[2] % sp:
        raise ValueError(f"sequence length {shape[2]} not divisible by "
                         f"sp={sp}")
    if mode not in MODES:
        raise ValueError(mode)
    group = mesh.group("sp")
    inner = allgather_kv_attention if mode == "allgather" else ring_attention

    def fn(q, k, v, replicated: int = 0):
        return _sync_rows(inner(q, k, v, group, replicated), replicated, group)

    return fn


# -- Ulysses head parallelism -------------------------------------------------


def head_shard_axes(mesh: Mesh, batch: int, heads: int):
    """(batch_axis, head_axes) for Ulysses head parallelism: the batch is
    already each dp rank's own (None); heads split over 'sp' when it
    divides them, else () (the caller gathers the tokens instead)."""
    sp = mesh.shape["sp"]
    return None, (("sp",) if sp > 1 and heads % sp == 0 else ())


class _SeqToHeads(torch.autograd.Function):
    """[B, H, S/sp, D] token slices -> [B, H/sp, S, D] head slices over
    all tokens (all_to_all_single); backward: the inverse."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.group), None


def _seq_to_heads(x, group):
    n = dist.get_world_size(group)
    b, h, s, d = x.shape
    if h % n:
        raise ValueError(f"{h} heads do not divide over sp={n}")
    send = x.reshape(b, n, h // n, s, d).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j]: rank j's tokens of this rank's heads
    return recv.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * s, d)


def _heads_to_seq(x, group):
    n = dist.get_world_size(group)
    b, hl, s, d = x.shape
    send = x.reshape(b, hl, n, s // n, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    # recv[j]: rank j's heads of this rank's tokens
    return recv.transpose(0, 1).reshape(b, n * hl, s // n, d)


def seq_to_heads(x: torch.Tensor, scope: SPScope) -> torch.Tensor:
    return _SeqToHeads.apply(x.contiguous(), scope.group)


def heads_to_seq(x: torch.Tensor, scope: SPScope) -> torch.Tensor:
    return _HeadsToSeq.apply(x.contiguous(), scope.group)


def allgather(x: torch.Tensor, dim: int, scope: SPScope) -> torch.Tensor:
    """Every sp rank's x concatenated along dim (backward: reduce-scatter)."""
    return _Gather.apply(x, dim, scope.group)


def to_heads(scope: SPScope, heads: int, xs):
    """Ulysses, in: (this rank's head slice of `heads`, xs [B, H, S/sp, D]
    as that slice over all tokens). When sp does not divide the heads,
    (None, xs gathered over all tokens, every head)."""
    if not head_shard_axes(scope.mesh, xs[0].shape[0], heads)[1]:
        return None, [allgather(x, 2, scope) for x in xs]
    count = heads // scope.size
    return (slice(scope.rank * count, (scope.rank + 1) * count),
            [seq_to_heads(x, scope) for x in xs])


def from_heads(scope: SPScope, heads: Optional[slice], x: torch.Tensor
               ) -> torch.Tensor:
    """Ulysses, out: an output laid out as to_heads' inputs came back
    (`heads` as it returned) -> this rank's token slice of every head."""
    if heads is None:
        return _Split.apply(x, 2, scope.group)
    return heads_to_seq(x, scope)


def head_parallel_call(fn: Callable, mesh: Mesh, shape, n_args: int = 3
                       ) -> Callable:
    """Ulysses form of fn (positional [B, H, S, D] tensors -> [B, H, S, D],
    each head treated alike): the caller's token slices go to head slices
    over all tokens, fn runs on the rank's heads, and the output goes back
    to token slices (to_heads, from_heads). When sp does not divide the
    heads, every rank gathers the tokens, runs fn on all heads and keeps
    its slice."""
    scope = SPScope(mesh)

    def call(*args):
        if len(args) != n_args:
            raise TypeError(f"expected {n_args} tensors, got {len(args)}")
        heads, xs = to_heads(scope, shape[1], args)
        return from_heads(scope, heads, fn(*xs))

    return call
