// K5: fused local + global sliding-window attention forward: the windowed
// softmax of the SWA local pass and the independent softmax of its global
// "cross" pass, each normalised, summed at the store (the reference adds the
// two normalised outputs, processor.py:436).
//
// Replaces the TPU kernel easyanimate_tpu/ops/swa.py::_swa_fused_kernel
// (driven by _swa_local_global_fwd). The TPU kernel reads one kv input that
// its wrapper builds per layer by concatenation, [local | pad | global |
// pad] (kv_aug / vv_aug), walks window offsets and then the global tiles on
// its sequential grid axis, and removes both pad masses in closed form at
// the store. Here the local k, v [bh, S, d] and the global gk, gv
// [bh, Sg, d] stay separate tensors, so no per-layer copy is made, and both
// walks hide the pad columns by index (j < S and |i - j| <= W; j < Sg), as
// K1 and K2 do.
//
// What it computes: o = softmax2 over the band of q k^T, times v, plus
// softmax2 over the Sg global rows of q gk^T, times gv, each half
// normalised by its own row sum, summed in f32 and rounded once to bf16;
// q pre-scaled by sm_scale * log2(e). No lse: the backward recomputes
// through the unfused pair (K2 + K6/K7, K1 + K3/K4).
//
// Bound on the H100: at the flagship call (b*h 96, S 13,104, d 64, W
// 1,008, Sg 1,027) the band holds 25,413,696 visible pairs a head and the
// global pass 13,104 x 1,027, so the 4 products take 2 * 2 * 96 *
// (25,413,696 + 13,457,808) * 64 = 0.955 TFLOP: 0.966 ms at 989 TFLOP/s,
// against 0.20 ms for the q/k/v/gk/gv/o bytes. It is bound by operations.
//
// Design at head_dim 64 (every production preset), swa_fused_fwd_sm90
// below: K2's TMA + wgmma block (fwd_sm90.cuh: a producer warpgroup
// streaming 128-row k/v tiles by TMA through a 2-stage mbarrier ring; 3
// consumer warpgroups of 64 q rows at 160 registers; SS wgmma for the
// scores, RS wgmma for p v), one q load and one store for both walks:
//   - the producer walks K2's band tiles from max(0, q0 - W), then the
//     ceil(Sg / 128) global tiles from row 0 through two more tensor maps
//     (gk, gv over Sg rows: rows past Sg arrive as zeros and no tile reads
//     another head's rows). It keeps one tile count over both walks, so
//     the consumers' mbarrier parities follow without a reset. It is K5's
//     own producer: fwd90::produce stays as K1 and K2 compiled it;
//   - the band walk is K2's loop: a tile wholly outside a consumer's band
//     only releases its stage, an edge tile takes mask_band;
//   - at the switch each consumer finishes o_local = o / l (0 for a row
//     that saw nothing: its rows past S) and stashes it in f32 in shared
//     memory, 48 KB for the block in a [value][thread] layout that is
//     conflict-free on write and read back; then o and the row stats start
//     again. The block grows from 88 KB to 136 KB, still one a SM (the
//     registers allow no second). o_local is not kept in registers: next
//     to o, the scores and p it would add 32 live values to code that
//     ptxas already fits into the launch's 128 (not tried);
//   - the global walk is K1's loop: no band test; the last tile's columns
//     j >= Sg set to -inf (mask_tail), since its zero rows would score 0
//     and take the max of a row whose real scores are all very negative;
//   - the epilogue forms o_local + o / l in f32, rounds once into the
//     consumer's own q rows of shared memory in the swizzled layout and
//     stores them by one TMA store (fwd90::store_o), which clips rows past
//     S (the last block's consumers past S compute on zero q).
// ptxas gives it 128 registers and 32 + 32 bytes of spills: four 8-byte
// values stored once before the global walk and reloaded on each global
// tile, as K1 reloads its 16 bytes. Tried on the card and dropped: forming
// the stash pointer only where it is used, and rebuilding q's descriptor
// on every tile (ptxas hoists both back: the same instructions and
// spills).
//
// Head dims 16 and 32 (the tiny test preset only) stay on the mma.sync body
// of attn_fwd.cuh: a dispatch by shape in ea_swa_fused_fwd_bf16, never a
// fallback on failure. ea_swa_fused_fwd_uses_sm90 tells the wrapper which
// ran.
#include "fwd_sm90.cuh"

namespace ea {

template <int D>
__global__ void __launch_bounds__(kThreads)
swa_fused_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ gk,
                     const __nv_bfloat16* __restrict__ gv,
                     __nv_bfloat16* __restrict__ o, int s, int sg,
                     int window) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockQ][kRow<D>];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockKV][kRow<D>];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockKV][kRow<D>];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  load_tile<D, kBlockQ>(sQ, q + (size_t)bh * s * D, q0, s);
  __syncthreads();
  const int r0 = warp * 16;
  QFrags<D> qa;
  load_q_frags<D>(qa, sQ, r0, g, t);
  const int row_a = q0 + r0 + g;
  const int row_b = row_a + 8;

  // stats set 1: the band of the permuted video tokens
  SoftmaxState<D> st;
  st.reset();
  attend_tiles<D, true>(st, qa, sK, sV, k + (size_t)bh * s * D,
                        v + (size_t)bh * s * D, max(0, q0 - window),
                        min(s, q0 + kBlockQ + window), s, window, row_a,
                        row_b, g, t);
  float inv_a, inv_b;
  st.finish(inv_a, inv_b);
  float out[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    out[dt][0] = st.acc[dt][0] * inv_a;
    out[dt][1] = st.acc[dt][1] * inv_a;
    out[dt][2] = st.acc[dt][2] * inv_b;
    out[dt][3] = st.acc[dt][3] * inv_b;
  }

  // stats set 2: every query against all Sg global rows
  st.reset();
  attend_tiles<D, false>(st, qa, sK, sV, gk + (size_t)bh * sg * D,
                         gv + (size_t)bh * sg * D, 0, sg, sg, 0, row_a, row_b,
                         g, t);
  st.finish(inv_a, inv_b);

  __nv_bfloat16* ob = o + (size_t)bh * s * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < s) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_a * D + col) =
          pack_f32(out[dt][0] + st.acc[dt][0] * inv_a,
                   out[dt][1] + st.acc[dt][1] * inv_a);
    }
    if (row_b < s) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_b * D + col) =
          pack_f32(out[dt][2] + st.acc[dt][2] * inv_b,
                   out[dt][3] + st.acc[dt][3] * inv_b);
    }
  }
}

namespace k5 {

using fwd90::kBlockM;
using fwd90::kBlockN;
using fwd90::kConsumerRegs;
using fwd90::kConsumers;
using fwd90::kD;
using fwd90::kStages;
using fwd90::kThreads;

// K1's and K2's block (q, the k/v ring, the barriers) and the consumers'
// stashed o_local: value i of consumer thread tid at stash[c][128 i + tid].
struct Smem {
  fwd90::Smem ring;
  float stash[kConsumers][32 * 128];
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

// The producer warpgroup: one thread loads the block's q rows once, then
// n_band k and v tiles from kv row kv_begin on and the global tiles from
// gk, gv row 0 on, n_tiles in all, through the ring. The consumers count
// the same tiles, as the mbarrier parities need.
__device__ __forceinline__ void produce(fwd90::Smem& sm, const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        const CUtensorMap* tm_gk,
                                        const CUtensorMap* tm_gv, int q0,
                                        int bh, int kv_begin, int n_band,
                                        int n_tiles) {
  sm90::setmaxnreg_dec<fwd90::kProducerRegs>();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(&sm.q_full, fwd90::kQBytes);
    sm90::tma_load_3d(sm.q, tm_q, &sm.q_full, 0, q0, bh);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      // the first pass over the ring finds every stage free
      sm90::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * fwd90::kTileBytes);
      const bool band = j < n_band;
      const int row = band ? kv_begin + j * kBlockN : (j - n_band) * kBlockN;
      sm90::tma_load_3d(sm.k[s], band ? tm_k : tm_gk, &sm.full[s], 0, row, bh);
      sm90::tma_load_3d(sm.v[s], band ? tm_v : tm_gv, &sm.full[s], 0, row, bh);
    }
  }
}

// 1 / (a row's sum over its quad), or 1 for a row that saw nothing (its o
// is 0).
__device__ __forceinline__ float inv_row_sum(float l) {
  l = fwd90::quad_sum(l);
  return l <= 0.f ? 1.f : 1.f / l;
}

// One consumer warpgroup: its 64 q rows against the block's band tiles,
// o_local stashed, then against the global tiles, then the store of the
// sum.
__device__ __forceinline__ void consume(Smem& smem, const CUtensorMap* tm_o,
                                        int c, int bh, int q0, int s, int sg,
                                        int window, int kv_begin, int n_band,
                                        int n_tiles) {
  fwd90::Smem& sm = smem.ring;
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
  int j = 0;
  for (; j < n_band; ++j) {
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

  // the switch: o_local = o / l (or 0 for a row that saw nothing) into the
  // stash; o and the row stats start again for the global softmax
  float* stash = smem.stash[c] + tid;
  {
    const float inv_a = inv_row_sum(st.l_a), inv_b = inv_row_sum(st.l_b);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      stash[128 * i] = o[i] * ((i & 2) ? inv_b : inv_a);
      o[i] = 0.f;
    }
    st = fwd90::RowStats{-INFINITY, -INFINITY, 0.f, 0.f};
  }

  for (; j < n_tiles; ++j) {
    const int stage = j % kStages;
    sm90::mbar_wait(&sm.full[stage], (j / kStages) & 1);
    float sc[64];
    sm90::wgmma_fence();
    fwd90::issue_qk(sc, desc_q, sm.k[stage]);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    fwd90::mask_tail(sc, (j - n_band) * kBlockN, sg, t);
    fwd90::softmax_pv(sc, o, st, sm, stage, lane);
  }

  // o_local + o / l, rounded once at the store
  const float inv_a = inv_row_sum(st.l_a), inv_b = inv_row_sum(st.l_b);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    o[i] = fmaf(o[i], (i & 2) ? inv_b : inv_a, stash[128 * i]);
  }
  fwd90::store_o(o, 1.f, 1.f, sq_c, tm_o, c, bh, q0, s, tid, t, r_a, r_b);
}

__global__ void __launch_bounds__(kThreads, 1)
swa_fused_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_gk,
                   const __grid_constant__ CUtensorMap tm_gv,
                   const __grid_constant__ CUtensorMap tm_o, int s, int sg,
                   int window) {
  Smem& sm = reinterpret_cast<Smem&>(fwd90::init_smem());
  const int warpgroup = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  // window <= s (the launch ensures it), so no sum overflows
  const int kv_begin = max(0, q0 - window);
  const int n_band =
      (min(s, q0 + kBlockM + window) - kv_begin + kBlockN - 1) / kBlockN;
  const int n_tiles = n_band + (sg + kBlockN - 1) / kBlockN;
  if (warpgroup == 0) {
    produce(sm.ring, &tm_q, &tm_k, &tm_v, &tm_gk, &tm_gv, q0, bh, kv_begin,
            n_band, n_tiles);
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume(sm, &tm_o, warpgroup - 1, bh, q0, s, sg, window, kv_begin,
            n_band, n_tiles);
  }
}

int launch(const void* q, const void* k, const void* v, const void* gk,
           const void* gv, void* o, int bh, int s, int sg, int window,
           cudaStream_t stream) {
  if (window > s) window = s;  // |i - j| < S: a wider window sees the same
  fwd90::Maps m;
  CUtensorMap tm_gk, tm_gv;
  const uint64_t g_head = (uint64_t)sg * fwd90::kRowBytes;
  int err = fwd90::encode_maps(m, q, k, v, o, bh, s, s, s);
  if (!err) err = sm90::encode_rows_sw128(&tm_gk, gk, sg, bh, g_head, kBlockN);
  if (!err) err = sm90::encode_rows_sw128(&tm_gv, gv, sg, bh, g_head, kBlockN);
  if (!err) err = sm90::check_launch_regs(swa_fused_fwd_sm90, fwd90::kLaunchRegs);
  if (err) return err;
  cudaError_t st = cudaFuncSetAttribute(
      swa_fused_fwd_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (st != cudaSuccess) return static_cast<int>(st);
  const dim3 grid((s + kBlockM - 1) / kBlockM, bh);
  swa_fused_fwd_sm90<<<grid, kThreads, kSmemBytes, stream>>>(
      m.q, m.k, m.v, tm_gk, tm_gv, m.o, s, sg, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k5
}  // namespace ea

extern "C" int ea_swa_fused_fwd_uses_sm90(int head_dim) {
  return head_dim == ea::fwd90::kD;
}

extern "C" int ea_swa_fused_fwd_bf16(const void* q, const void* k,
                                     const void* v, const void* gk,
                                     const void* gv, void* o, int bh, int s,
                                     int sg, int window, int head_dim,
                                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (ea_swa_fused_fwd_uses_sm90(head_dim)) {
    return ea::k5::launch(q, k, v, gk, gv, o, bh, s, sg, window, st);
  }
  const dim3 grid((s + ea::kBlockQ - 1) / ea::kBlockQ, bh);
  const dim3 block(ea::kThreads);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* gkp = static_cast<const __nv_bfloat16*>(gk);
  const auto* gvp = static_cast<const __nv_bfloat16*>(gv);
  auto* op = static_cast<__nv_bfloat16*>(o);
  switch (head_dim) {
    case 16:
      ea::swa_fused_fwd_kernel<16><<<grid, block, 0, st>>>(
          qp, kp, vp, gkp, gvp, op, s, sg, window);
      break;
    case 32:
      ea::swa_fused_fwd_kernel<32><<<grid, block, 0, st>>>(
          qp, kp, vp, gkp, gvp, op, s, sg, window);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
