// K6 and K7: sliding-window (banded) attention backward for the local pass
// of the V5.1 SWA layers (the training step's gradient of K2): only pairs
// with |i - j| <= window and i, j < S contribute.
//
// Replaces the TPU kernels easyanimate_tpu/ops/swa.py::_swa_bwd_dq_kernel
// (K6) and ::_swa_bwd_dkv_kernel (K7), driven by _swa_bwd. The TPU grid
// enumerates window offsets, clamps the tile address at the sequence ends
// and masks the clamped duplicate tiles away, carrying the sums in VMEM
// across the sequential offset axis. Nothing carries between CUDA blocks,
// so each block loops over exactly the tiles its rows can see:
// kv rows [q0 - W, q0 + 64 + W) for dq, q rows [k0 - W, k0 + 128 + W) for
// dk/dv. There are no duplicate tiles to predicate away.
//
// What they compute, from K2's residuals (q pre-scaled by sm_scale *
// log2(e); q, k, v, do bf16 [bh, S, d]; lse and di = rowsum(o * do) f32
// [bh, S]): p = exp2(q k^T - lse), ds = p (do v^T - di), dq = ln2 * ds k
// (K6), dk = ln2 * ds^T q and dv = p^T do (K7).
//
// Bound on the H100: at the flagship call (b*h = 96, S = 13,104, window
// 1,008) the band holds 25,413,696 visible pairs a head; K6 runs 3 products
// and K7 4 of 2 * pairs * 64 operations (0.947 and 1.263 ms at 989
// TFLOP/s) against ~0.8 and ~1.0 GB of q/k/v/do/lse/di/gradient traffic
// (0.24 and 0.29 ms at 3.35 TB/s): both are bound by operations.
//
// K7 at head_dim 64 (every production preset), swa_bwd_dkv_sm90 below: K4's
// TMA + wgmma dk/dv block from bwd_sm90.cuh (a producer warpgroup: one TMA
// thread loads the block's 128 k/v rows once and streams 64-row q/do tiles
// through a 3-stage mbarrier ring, one warp copies each tile's lse and di;
// 2 consumer warpgroups of 64 kv rows, 240 registers: SS wgmma for the
// transposed scores s^T = k q^T and dp^T = v do^T, RS wgmma for dv += p^T do
// and dk += ds^T q; the swizzled TMA stores), with K2's kind of walk
// (swa_fwd.cu) mirrored onto the q side:
//   - the walk: the block of kv rows [k0, k0 + 128) visits q rows
//     [max(0, k0 - W), min(S, k0 + 128 + W)) in 64-row tiles from the first
//     (not 64-aligned: a TMA box starts at any row). At the flagship a
//     block visits 34 tiles (2,144 rows) for each consumer's band of 2,080;
//     K4's dense walk visits 209. The q/do maps take S as their row extent,
//     so rows past S arrive as zeros, with lse +inf and di 0: p = 0 there;
//   - the mask: a q tile that crosses the band's edge for a consumer's 64
//     kv rows (a test uniform across the warpgroup: about 2 tiles at each
//     end of the walk) sets s^T = -inf before the exponential where
//     |i - j| > W; interior tiles take no mask;
//   - a tile wholly outside a consumer's band (at the flagship the first
//     for consumer 1, the last for consumer 0), or any tile of a consumer
//     whose rows all lie past S, runs none of the four products: the
//     consumer only waits for the stage and releases it;
//   - kv rows >= S in the last block arrive as zero k and v rows, whose
//     p^T is 2^(-lse), not 0 (inf once lse < -128): a row of dk (dv)
//     depends only on the same row of ds^T (p^T), so the epilogue writes
//     those rows as zeros, as in K4, and the TMA store clips rows past S.
// Each kernel keeps its own consumer loop on bwd_sm90.cuh's pieces (see
// there). Per q tile a block runs 4 products of 2 * 128 * 64 * 64 (~1,024
// tensor-core cycles at the peak) against 8,192 exponentials.
//
// K6, and K7 at head dims 16 and 32 (the tiny test preset only), run the
// mma.sync bodies of attn_bwd.cuh: a dispatch by shape in the entry points
// below, never a fallback on failure. ea_swa_bwd_dkv_uses_sm90 tells the
// wrapper which ran.
#include "bwd_sm90.cuh"

namespace ea {
namespace k7 {

using namespace bwd90;
using namespace bwd90::dkv;

// Whether the q tile at col0 hides any (hides_any) or every (hides_all)
// pair with the kv rows [row0, row0 + 64): kv row j sees the q rows i with
// |i - j| <= window (rows i >= S are zeros with p = 0, and kv rows j >= S
// are zeroed by the epilogue, so neither needs the mask).
__device__ __forceinline__ bool hides_any(int col0, int row0, int window) {
  return row0 + 63 - col0 > window || col0 + kBlockM - 1 - row0 > window;
}

__device__ __forceinline__ bool hides_all(int col0, int row0, int window) {
  return col0 + kBlockM - 1 < row0 - window || col0 > row0 + 63 + window;
}

// The hidden transposed scores of a thread's kv rows row_a and row_a + 8
// (t its index in the quad) set to -inf: element 4i + e holds q column
// col0 + 8i + 2t + (e & 1), of row_a for e < 2 and of row_a + 8 after.
__device__ __forceinline__ void mask_band(float (&st)[kBlockM / 2], int col0,
                                          int row_a, int window, int t) {
  // the visible columns of row_a, counted from the tile's first
  const int lo = row_a - window - col0, hi = row_a + window - col0;
#pragma unroll
  for (int i = 0; i < kBlockM / 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * i + 2 * t + e;
      if (c < lo || c > hi) st[4 * i + e] = -INFINITY;
      if (c < lo + 8 || c > hi + 8) st[4 * i + 2 + e] = -INFINITY;
    }
  }
}

// One consumer warpgroup: its 64 kv rows against the block's q tiles, then
// the stores of its dk and dv rows.
__device__ __forceinline__ void consume(Smem& sm, const CUtensorMap* tm_dk,
                                        const CUtensorMap* tm_dv, int c,
                                        int bh, int k0, int s, int window,
                                        int q_begin, int n_tiles) {
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int row0 = k0 + c * 64;  // the consumer's first kv row
  const int row_a = row0 + (tid / 32) * 16 + lane / 4;
  const bool past_s = row0 >= s;  // every row a zero row of the last block
  const uint64_t desc_k = sm90::desc_sw128(sm.k + c * 64 * kD, 16, 1024);
  const uint64_t desc_v = sm90::desc_sw128(sm.v + c * 64 * kD, 16, 1024);

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  sm90::mbar_wait(&sm.kv_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    sm90::mbar_wait(&sm.full[stage], (j / kStages) & 1);
    const int col0 = q_begin + j * kBlockM;
    if (past_s || hides_all(col0, row0, window)) {
      release(sm, stage, lane);  // nothing visible: only release the stage
      continue;
    }
    float st[kBlockM / 2], dp[kBlockM / 2];
    tile_scores(st, dp, desc_k, desc_v, sm, stage);
    if (hides_any(col0, row0, window)) mask_band(st, col0, row_a, window, t);
    tile_accumulate(dk, dv, st, dp, sm, stage, t, lane);
  }
  store_dk_dv(sm, tm_dk, tm_dv, dk, dv, c, bh, row0, s, s);
}

__global__ void __launch_bounds__(kBlockThreads, 1)
swa_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_dk,
                 const __grid_constant__ CUtensorMap tm_dv,
                 const float* __restrict__ lse,
                 const float* __restrict__ di, int s, int window) {
  Smem& sm = init_smem();
  const int warpgroup = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockN;
  // window <= s (the launch ensures it), so no sum overflows; k0 < s, so
  // every block walks at least one tile
  const int q_begin = max(0, k0 - window);
  const int n_tiles =
      (min(s, k0 + kBlockN + window) - q_begin + kBlockM - 1) / kBlockM;
  if (warpgroup == 0) {
    produce(sm, &tm_q, &tm_do, &tm_k, &tm_v, lse, di, bh, s, k0, q_begin,
            n_tiles);
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume(sm, &tm_dk, &tm_dv, warpgroup - 1, bh, k0, s, window, q_begin,
            n_tiles);
  }
}

int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* di, void* dk, void* dv, int bh, int s,
           int window, cudaStream_t stream) {
  if (window > s) window = s;  // |i - j| < S: a wider window sees the same
  int err = sm90::check_launch_regs(swa_bwd_dkv_sm90, kLaunchRegs);
  if (err) return err;
  Maps m;
  err = encode_maps(m, q, dout, k, v, dk, dv, bh, s, s, s);
  if (err) return err;
  const cudaError_t st = cudaFuncSetAttribute(
      swa_bwd_dkv_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (st != cudaSuccess) return static_cast<int>(st);
  const dim3 grid((s + kBlockN - 1) / kBlockN, bh);
  swa_bwd_dkv_sm90<<<grid, kBlockThreads, kSmemBytes, stream>>>(
      m.q, m.dout, m.k, m.v, m.dk, m.dv, static_cast<const float*>(lse),
      static_cast<const float*>(di), s, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k7
}  // namespace ea

extern "C" int ea_swa_bwd_dkv_uses_sm90(int head_dim) {
  return head_dim == ea::bwd90::kD;
}

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
  if (ea_swa_bwd_dkv_uses_sm90(head_dim)) {
    return ea::k7::launch(q, k, v, dout, lse, di, dk, dv, bh, s, window,
                          reinterpret_cast<cudaStream_t>(stream));
  }
  return ea::launch_attn_bwd_dkv<true>(q, k, v, dout, lse, di, dk, dv, bh, s,
                                       s, s, window, head_dim, stream);
}
