// K2: sliding-window (banded) attention forward for the local pass of the
// V5.1 SWA layers: row i sees columns j < S with |i - j| <= window.
//
// Replaces the TPU kernel easyanimate_tpu/ops/swa.py::_swa_kernel (driven by
// _swa_fwd). The TPU kernel enumerates window offsets on its sequential grid
// axis, clamps the kv block address and predicates duplicate tiles away, and
// removes the zero-pad tail's mass per row in closed form. Here each block
// loops over exactly the kv rows its q rows can see, with no clamp and no
// duplicate tiles, and hides the rest by index.
//
// What it computes: o = softmax2(q k^T) v over the band, q pre-scaled by
// sm_scale * log2(e), an online base-2 softmax in f32; o bf16 [bh, S, d],
// lse2 f32 [bh, S, 1] (base 2), the residual K6 and K7 read.
//
// Bound on the H100: at the flagship call (b*h = 96, S = 13,104, window
// 1,008: one latent frame, all 6 permuted head groups in one call) the band
// holds 25,413,696 visible (i, j) pairs a head, so the 2 products take
// 2 * 2 * 96 * 25,413,696 * 64 = 0.625 TFLOP: 0.632 ms at 989 TFLOP/s,
// against 0.19 ms for the q/k/v/o/lse bytes. It is bound by operations.
//
// Design at head_dim 64 (every production preset), swa_fwd_sm90 below: K1's
// TMA + wgmma block (a producer warpgroup streaming 128-row k/v tiles by TMA
// through a 2-stage mbarrier ring; 3 consumer warpgroups of 64 q rows, SS
// wgmma for q k^T, RS wgmma for p v; the swizzled TMA store), from
// fwd_sm90.cuh, with its own walk and mask:
//   - the walk: the block of q rows [q0, q0 + 192) visits kv rows
//     [max(0, q0 - W), min(S, q0 + 192 + W)) in 128-row tiles from the
//     first (not 128-aligned: a TMA box starts at any row). At the flagship
//     a block visits 18 tiles (2,304 rows) for its band of 2,208; K1's dense
//     walk visits 105. The k/v maps take S as their row extent, so rows past
//     S arrive as zeros and no tile reads another head's rows;
//   - the mask: a tile that crosses the band's edge for a consumer's 64 rows
//     (a test uniform across the warpgroup: about 2 tiles at each end of the
//     walk) sets s = -inf before the row max for j >= S or |i - j| > W;
//     interior tiles take no mask. j >= S matters: the zero rows past S
//     score 0, which would take the max of a row whose visible scores are
//     all very negative. A row that has seen nothing yet keeps m = -inf and
//     K1's guard exponentiates it against 0;
//   - a tile that lies wholly outside a consumer's band (the outer
//     consumers' first or last) runs neither product: the consumer only
//     waits for the stage and releases it.
// K2 keeps its own consumer loop rather than sharing K1's through a
// template on the walk, which cost K1 spills (fwd_sm90.cuh). Tried on the
// card and dropped: 2 consumers of 240 registers (128 q rows a block: the
// walk pads 8% rather than 14%, but each block loads its band for fewer
// rows), about 10% slower; the products run on the wholly hidden tiles too,
// about 4% slower, with 32 bytes of spills (none with the skip).
//
// Head dims 16 and 32 (the tiny test preset only) stay on the mma.sync body
// of attn_fwd.cuh: a dispatch by shape in ea_swa_fwd_bf16, never a fallback
// on failure. ea_swa_fwd_uses_sm90 tells the wrapper which ran.
#include "fwd_sm90.cuh"

namespace ea {
namespace k2 {

using fwd90::kBlockM;
using fwd90::kBlockN;
using fwd90::kConsumerRegs;
using fwd90::kD;
using fwd90::kSmemBytes;
using fwd90::kStages;
using fwd90::kThreads;
using fwd90::Smem;

// One consumer warpgroup: its 64 q rows against the block's kv tiles, then
// the store.
__device__ __forceinline__ void consume(Smem& sm, const CUtensorMap* tm_o,
                                        float* __restrict__ lse, int c,
                                        int bh, int q0, int s, int window,
                                        int kv_begin, int n_tiles) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_a = warp * 16 + g;  // this thread's two rows in the 64
  const int r_b = r_a + 8;
  const int row0 = q0 + c * 64;   // the consumer's first q row
  __nv_bfloat16* sq_c = sm.q + c * 64 * kD;  // this consumer's q rows
  const uint64_t desc_q = sm90::desc_sw128(sq_c, 16, 1024);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  fwd90::RowStats st{-INFINITY, -INFINITY, 0.f, 0.f};

  sm90::mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    sm90::mbar_wait(&sm.full[stage], (j / kStages) & 1);
    const int col0 = kv_begin + j * kBlockN;
    if (fwd90::hides_all(col0, row0, window)) {
      __syncwarp();  // nothing visible: only release the stage
      if (lane == 0) sm90::mbar_arrive(&sm.empty[stage]);
      continue;
    }
    float sc[64];
    sm90::wgmma_fence();
    fwd90::issue_qk(sc, desc_q, sm.k[stage]);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    if (fwd90::hides_any(col0, row0, s, window)) {
      fwd90::mask_band(sc, col0, row0 + r_a, row0 + r_b, s, window, t);
    }
    fwd90::softmax_pv(sc, o, st, sm, stage, lane);
  }
  fwd90::store_o_lse(o, st, sq_c, tm_o, lse, c, bh, q0, s, tid, t, r_a, r_b);
}

__global__ void __launch_bounds__(kThreads, 1)
swa_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
             const __grid_constant__ CUtensorMap tm_k,
             const __grid_constant__ CUtensorMap tm_v,
             const __grid_constant__ CUtensorMap tm_o,
             float* __restrict__ lse, int s, int window) {
  Smem& sm = fwd90::init_smem();
  const int warpgroup = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  // window <= s (the launch ensures it), so no sum overflows
  const int kv_begin = max(0, q0 - window);
  const int n_tiles =
      (min(s, q0 + kBlockM + window) - kv_begin + kBlockN - 1) / kBlockN;
  if (warpgroup == 0) {
    fwd90::produce(sm, &tm_q, &tm_k, &tm_v, q0, bh, kv_begin, n_tiles);
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume(sm, &tm_o, lse, warpgroup - 1, bh, q0, s, window, kv_begin,
            n_tiles);
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int s, int window, cudaStream_t stream) {
  if (window > s) window = s;  // |i - j| < S: a wider window sees the same
  fwd90::Maps m;
  int err = fwd90::encode_maps(m, q, k, v, o, bh, s, s, s);
  if (!err) err = sm90::check_launch_regs(swa_fwd_sm90, fwd90::kLaunchRegs);
  if (err) return err;
  cudaError_t st = cudaFuncSetAttribute(
      swa_fwd_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (st != cudaSuccess) return static_cast<int>(st);
  const dim3 grid((s + kBlockM - 1) / kBlockM, bh);
  swa_fwd_sm90<<<grid, kThreads, kSmemBytes, stream>>>(
      m.q, m.k, m.v, m.o, static_cast<float*>(lse), s, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k2
}  // namespace ea

extern "C" int ea_swa_fwd_uses_sm90(int head_dim) {
  return head_dim == ea::fwd90::kD;
}

extern "C" int ea_swa_fwd_bf16(const void* q, const void* k, const void* v,
                               void* o, void* lse, int bh, int s, int window,
                               int head_dim, void* stream) {
  if (ea_swa_fwd_uses_sm90(head_dim)) {
    return ea::k2::launch(q, k, v, o, lse, bh, s, window,
                          reinterpret_cast<cudaStream_t>(stream));
  }
  return ea::launch_attn_fwd<true>(q, k, v, o, lse, bh, s, s, s, window,
                                   head_dim, stream);
}
