// K3 and K4: dense flash-attention backward for the MMDiT joint text+video
// attention and the SWA cross pass (the training step's gradient of K1).
//
// Replaces the TPU kernels easyanimate_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (K3) and ::_bwd_dkv_kernel (K4), driven by _flash_bwd. The
// TPU kernels carry the dq / dk, dv sums in VMEM scratch across their
// sequential grid axis and rely on zero-padded k and v: there the pad
// columns get p = 2^(-lse), not 0, and the wrapper slices the pad rows'
// dk/dv away. Here a CUDA block loops over the tiles itself, and p is
// masked to 0 by index for j >= kv_valid, so the dk/dv rows in
// [kv_valid, skv) come out exactly 0 and no padded copies exist.
//
// Bound on the H100: at the dense flagship shape (b*h = 96, S = 13,360,
// d = 64) the gradient needs 5 products of 2*S^2*d per head (11.0 TFLOP);
// because both kernels recompute s and dp, the pair executes 7 (15.3 TFLOP)
// for ~1 GB of q/k/v/do/dq/dk/dv traffic: compute-bound. The simple
// mma.sync body (attn_bwd.cuh) has no copy/compute overlap and runs well
// below the wgmma peak.
#include "attn_bwd.cuh"

extern "C" int ea_flash_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* di, void* dq,
                                    int bh, int sq, int skv, int kv_valid,
                                    int head_dim, void* stream) {
  return ea::launch_attn_bwd_dq<false>(q, k, v, dout, lse, di, dq, bh, sq,
                                       skv, kv_valid, /*window=*/0, head_dim,
                                       stream);
}

extern "C" int ea_flash_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* di,
                                     void* dk, void* dv, int bh, int sq,
                                     int skv, int kv_valid, int head_dim,
                                     void* stream) {
  return ea::launch_attn_bwd_dkv<false>(q, k, v, dout, lse, di, dk, dv, bh,
                                        sq, skv, kv_valid, /*window=*/0,
                                        head_dim, stream);
}
