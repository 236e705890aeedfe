"""Dense attention over [bh, S, d]: the hand-written Hopper kernels
(csrc/flash_fwd.cu, K1; csrc/flash_bwd.cu, K3 and K4; all three TMA +
wgmma kernels at d 64, K1 also at d 88, 72 and 144), their plain PyTorch
versions, and the autograd Function that joins them.

All take q pre-scaled by sm_scale * log2(e) (ops/attention.py folds it in
and rounds back to the input dtype, as the JAX wrapper does at
easyanimate_tpu/ops/flash_attention.py:455, outside its custom_vjp), so the
softmax runs in base 2. The forward returns (o, lse2) with lse2 the base-2
logsumexp [bh, Sq, 1] in float32 -- the residual the backward recomputes p
from. The backward returns the gradients with respect to the pre-scaled q,
k and v; autograd applies the sm_scale * log2(e) of the fold to dq.
"""
import math
from typing import Optional, Tuple

import torch

from . import _build

LOG2E = math.log2(math.e)
LN2 = math.log(2.0)

Pair = Tuple[torch.Tensor, torch.Tensor]
Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _kv_valid(kf: torch.Tensor, kv_valid: Optional[int]) -> int:
    skv = kf.shape[1]
    kv_valid = skv if kv_valid is None else int(kv_valid)
    if not 0 < kv_valid <= skv:
        raise ValueError(f"kv_valid {kv_valid} outside (0, {skv}]")
    return kv_valid


def flash_attention_plain(qf: torch.Tensor, kf: torch.Tensor,
                          vf: torch.Tensor, kv_valid: Optional[int] = None,
                          block_q: int = 512) -> Pair:
    """K1's plain version: q-chunked float32 base-2 softmax, following
    attention_xla_chunked (easyanimate_tpu/ops/attention.py:57). Live memory
    is O(block_q * S_kv) per chunk, so it runs at the flagship shape where
    a dense [b*h, S, S] score tensor would not fit. Columns at or past
    kv_valid are excluded."""
    bh, sq, d = qf.shape
    kv = kf.shape[1] if kv_valid is None else kv_valid
    k32 = kf[:, :kv].float().transpose(1, 2)
    v32 = vf[:, :kv].float()
    o = torch.empty_like(qf)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=qf.device)
    for i in range(0, sq, block_q):
        s = torch.matmul(qf[:, i:i + block_q].float(), k32)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o[:, i:i + block_q] = (torch.matmul(p, v32) / l).to(o.dtype)
        lse[:, i:i + block_q] = m + torch.log2(l)
    return o, lse


def flash_attention_fwd(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                        kv_valid: Optional[int] = None) -> Pair:
    """Non-causal attention over pre-scaled q [bh, Sq, d] and k, v
    [bh, Skv, d] -> (o [bh, Sq, d], lse2 [bh, Sq, 1] float32).

    A CUDA tensor launches K1 (bf16, d in 16/32/64/72/88/144, contiguous)
    or raises; a CPU tensor takes flash_attention_plain.
    `flash_attention_fwd.launches` counts kernel launches,
    `.launches_by_dim` them by head dim, `.launches_sm90` those that ran a
    TMA + wgmma kernel (d 64, 88 and 72, and d 144 heads of at most 64 q
    and kv rows; d 16 and 32 and d 144 past 64 rows run the mma.sync
    one), `.launches_short` those of them that ran the short-head kernel
    (flash_fwd_short_sm90); `.launches_sm90_by_dim` and
    `.launches_short_by_dim` count those two by head dim."""
    bh, sq, d = qf.shape
    skv = kf.shape[1]
    kv_valid = _kv_valid(kf, kv_valid)
    if qf.device.type == "cpu":
        return flash_attention_plain(qf, kf, vf, kv_valid)
    _build.check_kernel_inputs(qf, kf, vf, kernel=_build.K1)
    if kf.shape != vf.shape or kf.shape[0] != bh or kf.shape[2] != d:
        raise ValueError(f"shapes q {tuple(qf.shape)} k {tuple(kf.shape)} "
                         f"v {tuple(vf.shape)}")
    o = torch.empty_like(qf)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=qf.device)
    _build.launch("ea_flash_fwd_bf16", qf.device, qf.data_ptr(),
                  kf.data_ptr(), vf.data_ptr(), o.data_ptr(), lse.data_ptr(),
                  bh, sq, skv, kv_valid, d)
    flash_attention_fwd.launches += 1
    lib = _build.load_library()
    sm90 = lib.ea_flash_fwd_uses_sm90(d, sq, skv)
    short = lib.ea_flash_fwd_uses_short(d, sq, skv)
    flash_attention_fwd.launches_sm90 += sm90
    flash_attention_fwd.launches_short += short
    for counts, n in ((flash_attention_fwd.launches_by_dim, 1),
                      (flash_attention_fwd.launches_sm90_by_dim, sm90),
                      (flash_attention_fwd.launches_short_by_dim, short)):
        counts[d] = counts.get(d, 0) + n
    return o, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_by_dim = {}
flash_attention_fwd.launches_sm90 = 0
flash_attention_fwd.launches_sm90_by_dim = {}
flash_attention_fwd.launches_short = 0
flash_attention_fwd.launches_short_by_dim = {}


def row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o * do) in float32, [bh, S, 1]: the backward's per-row
    term, computed outside the kernels as the JAX package does
    (easyanimate_tpu/ops/flash_attention.py:325)."""
    return torch.linalg.vecdot(o.float(), do.float()).unsqueeze(-1)


def flash_attention_bwd_plain(qf: torch.Tensor, kf: torch.Tensor,
                              vf: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor,
                              kv_valid: Optional[int] = None,
                              block_q: int = 256) -> Triple:
    """K3 + K4's plain version: q-chunked float32 recompute of
    p = exp2(q k^T - lse2) from the saved lse, O(block_q * S_kv) live memory
    like the forward's plain version. Returns (dq, dk, dv) in the inputs'
    dtypes, with respect to the pre-scaled q; dk and dv rows at or past
    kv_valid are 0."""
    sq = qf.shape[1]
    kv = kf.shape[1] if kv_valid is None else kv_valid
    k32, v32 = kf[:, :kv].float(), vf[:, :kv].float()
    di = row_dot(o, do)
    dq = torch.empty_like(qf)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=kf.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=vf.device)
    for i in range(0, sq, block_q):
        q32 = qf[:, i:i + block_q].float()
        do32 = do[:, i:i + block_q].float()
        p = torch.exp2(torch.matmul(q32, k32.transpose(1, 2))
                       - lse[:, i:i + block_q])
        ds = p * (torch.matmul(do32, v32.transpose(1, 2)) - di[:, i:i + block_q])
        dq[:, i:i + block_q] = (torch.matmul(ds, k32) * LN2).to(dq.dtype)
        dk[:, :kv] += torch.matmul(ds.transpose(1, 2), q32)
        dv[:, :kv] += torch.matmul(p.transpose(1, 2), do32)
    return dq, (dk * LN2).to(kf.dtype), dv.to(vf.dtype)


def flash_attention_bwd(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        kv_valid: Optional[int] = None) -> Triple:
    """Gradients (dq, dk, dv) of flash_attention_fwd's o, given its
    residuals (qf, kf, vf, o, lse2) and the cotangent do [bh, Sq, d].

    A CUDA tensor launches K3 (dq) then K4 (dk, dv), or raises: every
    tensor contiguous (a caller with a strided do makes it contiguous
    first), bf16 except the float32 lse, d in 16/32/64 (K3 and K4 have no
    d 88 instance: the JAX package trains no V4). A CPU tensor takes
    flash_attention_bwd_plain. `flash_attention_bwd.launches` counts calls
    that launched the pair, `.launches_sm90` those in which both ran their
    TMA + wgmma kernels (d 64; d 16 and 32 run the mma.sync ones)."""
    bh, sq, d = qf.shape
    skv = kf.shape[1]
    kv_valid = _kv_valid(kf, kv_valid)
    if qf.device.type == "cpu":
        return flash_attention_bwd_plain(qf, kf, vf, o, lse, do, kv_valid)
    _build.check_kernel_inputs(qf, kf, vf, o, do, kernel=_build.K3_K4)
    _build.check_row_stats(lse, qf)
    if (kf.shape != vf.shape or kf.shape[0] != bh or kf.shape[2] != d
            or o.shape != qf.shape or do.shape != qf.shape):
        raise ValueError(f"shapes q {tuple(qf.shape)} k {tuple(kf.shape)} "
                         f"v {tuple(vf.shape)} o {tuple(o.shape)} "
                         f"do {tuple(do.shape)}")
    di = row_dot(o, do)
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vf)
    ptrs = [x.data_ptr() for x in (qf, kf, vf, do, lse, di)]
    _build.launch("ea_flash_bwd_dq_bf16", qf.device, *ptrs, dq.data_ptr(),
                  bh, sq, skv, kv_valid, d)
    _build.launch("ea_flash_bwd_dkv_bf16", qf.device, *ptrs, dk.data_ptr(),
                  dv.data_ptr(), bh, sq, skv, kv_valid, d)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_sm90 += _build.load_library(
        ).ea_flash_bwd_uses_sm90(d)
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_sm90 = 0


class FlashAttention(torch.autograd.Function):
    """o = attention(qf, kf, vf) over pre-scaled q, differentiable:
    forward flash_attention_fwd (K1), backward flash_attention_bwd
    (K3 + K4) from the saved (qf, kf, vf, o, lse2) -- the port of the JAX
    custom_vjp at easyanimate_tpu/ops/flash_attention.py:388-413."""

    @staticmethod
    def forward(ctx, qf, kf, vf, kv_valid):
        o, lse = flash_attention_fwd(qf, kf, vf, kv_valid)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.kv_valid = kv_valid
        return o

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(qf, kf, vf, o, lse, do.contiguous(),
                                         ctx.kv_valid)
        return dq, dk, dv, None
