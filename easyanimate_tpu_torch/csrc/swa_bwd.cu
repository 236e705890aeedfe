// K6 and K7: sliding-window (banded) attention backward for the local pass
// of the V5.1 SWA layers (the training step's gradient of K2): only pairs
// with |i - j| <= window contribute.
//
// Replaces the TPU kernels easyanimate_tpu/ops/swa.py::_swa_bwd_dq_kernel
// (K6) and ::_swa_bwd_dkv_kernel (K7), driven by _swa_bwd. The TPU grid
// enumerates window offsets, clamps the tile address at the sequence ends
// and masks the clamped duplicate tiles away, carrying the sums in VMEM
// across the sequential offset axis. Nothing carries between CUDA blocks,
// so each block loops over exactly the tiles its rows can see:
// kv rows [q0 - W, q0 + 64 + W) for dq, q rows [k0 - W, k0 + 64 + W) for
// dk/dv, with the band and the sequence end masked by index before the
// exponential. There are no duplicate tiles to predicate away.
//
// Bound on the H100: with window 1,008 a 64-row tile visits ~2,100 rows of
// the other side, about 1/6 of the dense pair's work at the flagship shape
// ([96, 13,104, 64]); the same mma.sync body as K3/K4 (attn_bwd.cuh)
// bounds it, and ~5% of the visited scores fall outside the band.
#include "attn_bwd.cuh"

extern "C" int ea_swa_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* di, void* dq, int bh, int s,
                                  int window, int head_dim, void* stream) {
  return ea::launch_attn_bwd_dq<true>(q, k, v, dout, lse, di, dq, bh, s, s, s,
                                      window, head_dim, stream);
}

extern "C" int ea_swa_bwd_dkv_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* di, void* dk,
                                   void* dv, int bh, int s, int window,
                                   int head_dim, void* stream) {
  return ea::launch_attn_bwd_dkv<true>(q, k, v, dout, lse, di, dk, dv, bh, s,
                                       s, s, window, head_dim, stream);
}
