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
// kv rows [q0 - W, q0 + 128 + W) for dq, q rows [k0 - W, k0 + 128 + W) for
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
// At head_dim 64 (every production preset) both are bwd_sm90.cuh's TMA +
// wgmma blocks (flash_bwd.cu's note gives the design: a producer
// warpgroup whose TMA thread loads the block's own 128 rows once and
// streams the other side's 64-row tiles through an mbarrier ring; 2
// consumer warpgroups of 64 rows at 240 registers; swizzled TMA stores),
// each walking only its band, with K2's kind of walk (swa_fwd.cu):
//   - K6, swa_bwd_dq_sm90: K3's dq block. A block of q rows [q0, q0 + 128)
//     streams k/v tiles (4 stages) over kv rows [max(0, q0 - W),
//     min(S, q0 + 128 + W)), from the first (not 64-aligned: a TMA box
//     starts at any row); each consumer thread holds its two rows' lse and
//     di in registers. The k/v maps take S as their row extent, so kv rows
//     past S arrive as zeros: they score 0, whose p = 2^(-lse) overflows
//     once lse < -128, so the tile that crosses S masks its columns >= S
//     (K3's last-tile test). q rows past S get lse +inf and di 0, so p = 0
//     there, and the TMA store clips them;
//   - K7, swa_bwd_dkv_sm90: K4's dk/dv block. A block of kv rows [k0, k0 +
//     128) streams q/do tiles (3 stages) over q rows [max(0, k0 - W),
//     min(S, k0 + 128 + W)), with each tile's lse and di copied by the
//     producer's second warp. q rows past S arrive as zeros with lse +inf
//     and di 0: p = 0 there. kv rows >= S in the last block arrive as zero
//     k and v rows, whose p^T is 2^(-lse), not 0: a row of dk (dv) depends
//     only on the same row of ds^T (p^T), so the epilogue writes those rows
//     as zeros, as in K4, and the TMA store clips rows past S.
// In both, at the flagship a block walks 34 tiles (2,144 rows) for each
// consumer's band of 2,080 (K3's and K4's dense walks: 209), and the
// band's tests (bwd_sm90.cuh; uniform across a warpgroup) decide per tile
// and consumer:
//   - a tile wholly outside the consumer's band (at the flagship the first
//     for consumer 1, the last for consumer 0), or any tile of a consumer
//     whose rows all lie past S, runs no product: the consumer only waits
//     for the stage and releases it;
//   - a tile that crosses the band's edge (about 2 at each end of the walk)
//     sets the scores to -inf where |i - j| > W before the exponential;
//     interior tiles take no mask.
// Per tile a block runs 3 (K6) or 4 (K7) products of 2 * 128 * 64 * 64
// (~768 or ~1,024 tensor-core cycles at the peak) against 8,192
// exponentials. Each kernel keeps its own consumer loop on bwd_sm90.cuh's
// pieces (see there).
//
// Head dims 16 and 32 (the tiny test preset only) run the mma.sync bodies
// of attn_bwd.cuh: a dispatch by shape in the entry points below, never a
// fallback on failure. ea_swa_bwd_dq_uses_sm90 and ea_swa_bwd_dkv_uses_sm90
// tell the wrapper which ran.
#include "bwd_sm90.cuh"

namespace ea {
namespace k6 {

using namespace bwd90;
using namespace bwd90::dq;

// One consumer warpgroup: its 64 q rows against the block's kv tiles, then
// the store of its dq rows.
__device__ __forceinline__ void consume(Smem& sm, const CUtensorMap* tm_dq,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ di, int c,
                                        int bh, int q0, int s, int window,
                                        int kv_begin, int n_tiles) {
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32, t = lane % 4;
  const int row0 = q0 + c * 64;  // the consumer's first q row
  const int row_a = row0 + (tid / 32) * 16 + lane / 4;
  const bool past_s = row0 >= s;  // every row past S: nothing to store
  const uint64_t desc_q = sm90::desc_sw128(sm.q + c * 64 * kD, 16, 1024);
  const uint64_t desc_do = sm90::desc_sw128(sm.dout + c * 64 * kD, 16, 1024);
  const RowStats st = row_stats(lse, di, bh, s, row_a);

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  sm90::mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j % kStages;
    sm90::mbar_wait(&sm.full[stage], (j / kStages) & 1);
    const int col0 = kv_begin + j * kBlockN;
    if (past_s || hides_all(col0, row0, window)) {
      release(sm, stage, lane);  // nothing visible: only release the stage
      continue;
    }
    float sc[kBlockN / 2], dp[kBlockN / 2];
    tile_scores(sc, dp, desc_q, desc_do, sm, stage);
    if (hides_any(col0, row0, window)) mask_band(sc, col0, row_a, window, t);
    uint32_t da[kBlockN / 16][4];
    ds_tile(sc, dp, st, col0, s, t, da);  // and the columns >= S
    tile_accumulate(dq, da, sm, stage, lane);
  }
  store_dq(sm, tm_dq, dq, c, bh, row0, s);
}

__global__ void __launch_bounds__(kBlockThreads, 1)
swa_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_dq,
                const float* __restrict__ lse,
                const float* __restrict__ di, int s, int window) {
  Smem& sm = init_smem();
  const int warpgroup = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  // window <= s (the launch ensures it), so no sum overflows; q0 < s, so
  // every block walks at least one tile
  const int kv_begin = max(0, q0 - window);
  const int n_tiles =
      (min(s, q0 + kBlockM + window) - kv_begin + kBlockN - 1) / kBlockN;
  if (warpgroup == 0) {
    produce(sm, &tm_q, &tm_do, &tm_k, &tm_v, bh, q0, kv_begin, n_tiles);
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume(sm, &tm_dq, lse, di, warpgroup - 1, bh, q0, s, window, kv_begin,
            n_tiles);
  }
}

int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* di, void* dq, int bh, int s,
           int window, cudaStream_t stream) {
  if (window > s) window = s;  // |i - j| < S: a wider window sees the same
  int err = sm90::check_launch_regs(swa_bwd_dq_sm90, kLaunchRegs);
  if (err) return err;
  Maps m;
  err = encode_maps(m, q, dout, k, v, dq, bh, s, s, s);
  if (err) return err;
  const cudaError_t st = cudaFuncSetAttribute(
      swa_bwd_dq_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (st != cudaSuccess) return static_cast<int>(st);
  const dim3 grid((s + kBlockM - 1) / kBlockM, bh);
  swa_bwd_dq_sm90<<<grid, kBlockThreads, kSmemBytes, stream>>>(
      m.q, m.dout, m.k, m.v, m.dq, static_cast<const float*>(lse),
      static_cast<const float*>(di), s, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k6

namespace k7 {

using namespace bwd90;
using namespace bwd90::dkv;

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

extern "C" int ea_swa_bwd_dq_uses_sm90(int head_dim) {
  return head_dim == ea::bwd90::kD;
}

extern "C" int ea_swa_bwd_dkv_uses_sm90(int head_dim) {
  return head_dim == ea::bwd90::kD;
}

extern "C" int ea_swa_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* di, void* dq, int bh, int s,
                                  int window, int head_dim, void* stream) {
  if (ea_swa_bwd_dq_uses_sm90(head_dim)) {
    return ea::k6::launch(q, k, v, dout, lse, di, dq, bh, s, window,
                          reinterpret_cast<cudaStream_t>(stream));
  }
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
