// K1: dense flash-attention forward for the MMDiT joint text+video
// attention and the SWA cross pass.
//
// Replaces the TPU kernel easyanimate_tpu/ops/flash_attention.py::_fwd_kernel
// (driven by _flash_fwd). The TPU kernel zero-pads kv to a block multiple and
// subtracts the pad columns' softmax mass n_pad * 2^-m in closed form,
// because a mask costs VPU passes there. On the H100 the column mask is a
// compare and a select in registers, so this kernel masks j >= kv_valid
// directly and needs no padded copies of k and v.
//
// What it computes: o = softmax2(q k^T) v over q pre-scaled by
// sm_scale * log2(e), columns j >= kv_valid excluded, with an online base-2
// softmax in f32; o bf16 [bh, Sq, d], lse2 f32 [bh, Sq, 1] (base 2), the
// residuals K3/K4 read.
//
// Bound on the H100: the dense flagship call (b*h = 96, S = 13,360, d = 64)
// does 2 products of 2 * 96 * 13360^2 * 64 = 4.4 TFLOP against 0.14 GB of
// q/k/v/o/lse traffic, so it is bound by operations: 4.435 ms at 989 TFLOP/s
// (the SWA cross pass, 13,360 x 1,027: 0.341 ms).
//
// Design at head_dim 64 (every production preset), flash_fwd_sm90 below:
//   - a block of 4 warpgroups per (192 q rows, b*h), one block per SM:
//     warpgroup 0 is the producer (32 registers), whose one elected thread
//     loads the block's q tile once and then streams 128-row k and v tiles
//     by TMA through a ring of kStages shared-memory stages with full/empty
//     mbarriers; warpgroups 1-3 are consumers (160 registers), each owning
//     64 of the q rows. 192 rows a block (not 128) cut the k/v traffic from
//     L2 by a third: every block reads all of its head's k and v;
//   - tensor maps are 3-D (d, S, b*h): k and v take kv_valid as their row
//     extent, so rows past it (and past S) arrive as zeros and no tile reads
//     another head's rows; q and o take Sq;
//   - s = q k^T is one wgmma m64n128k16 per 16 of d, both operands in
//     shared memory (128-byte swizzle); the online softmax runs on the f32
//     accumulator in registers (rows reduced across the quad with shuffles,
//     columns >= kv_valid set to -inf on the last tile: the zero rows TMA
//     fills in would otherwise score 0);
//   - o += p v is one wgmma m64n64k16 per 16 kv columns with p re-packed to
//     bf16x2 in registers as the A operand and v read transposed from shared
//     memory; a consumer releases a stage (its empty barrier) only after
//     wgmma.wait_group shows its p v on that stage complete;
//   - epilogue: o * (1 / l) in bf16 is written into the consumer's own
//     (finished) q rows of shared memory in the swizzled layout and stored
//     by one TMA store, which clips rows past Sq; lse = m + log2(l).
// At d 64 a tile's exponentials (MUFU, 16 a cycle per SM) take as long as
// its products, so the kernel lives on overlap: within a consumer the
// products and the softmax run in turn, and the three consumers fill each
// other's gaps. Tried on the card and dropped: 2 consumers of 232
// registers (128 q rows), with or without issuing the next q k^T before
// the softmax; that overlap with 3 consumers (it spills at 160 registers);
// the consumers taking turns on named barriers; rings of 3 or 4 stages.
//
// The block's pieces live in fwd_sm90.cuh, which K2 (swa_fwd.cu) shares;
// the consumer loop below, over every kv tile with the last one masked, is
// K1's own.
//
// Design at head_dims 88 and 72, flash_fwd_d88_sm90 and flash_fwd_d72_sm90
// below on fwd_split_sm90.cuh. At 88: V4's HunyuanDiT (self attention
// over 36,864 tokens at 512x512x144f, the text cross pass over 77 + 256
// tokens, the CLIP cross pass over 16). At 72: the V1-V3 Transformer3D
// (the spatial self attention over one frame's 1,024 tokens, the text
// cross pass over 120, V3's Global_Self over 36,864). The same block,
// producer and consumer loop as at 64, with each row loaded as two TMA
// boxes: columns 0-63, 128-byte swizzle, and a hi box of the columns past
// 64 (at 88 columns 64-95, 64-byte swizzle, TMA filling 88-95 with zeros;
// at 72 columns 64-79, 32-byte swizzle, 72-79 zeros); q k^T as four k16
// steps of m64n96k16 over lo and two (88) or one (72) over hi, p v as
// m64n64k16 + m64n24k16 (88) or + m64n8k16 (72) a k step; kv tiles of 96
// rows through a ring of 4 stages, so that o (44 f32 at 88, 36 at 72),
// the scores (48) and p (24) fit the launch's 128 registers a thread; o's
// rescale skipped when neither of a thread's rows' max moved; p v issued
// in two halves, the second half's exponentials running while the first
// half's product is on the tensor cores. Bound on the H100: V4's self
// attention [32, 36,864, 88] does 4 * 32 * 36864^2 * 88 = 15.3 TFLOP,
// 15.48 ms at 989 TFLOP/s (q k^T over 96 columns costs 4.5% more); the
// text pass 0.140 ms (operations), the CLIP pass 0.125 ms (bytes: q and
// o). V3's Global_Self [32, 36,864, 72]: 12.66 ms (operations; q k^T over
// 80 columns costs 11% more). Tried on the card at 88 and dropped: 128-row
// kv tiles (they spill; at 72 they take a 256-byte stack frame); 2 or 3
// stages; p v at n32 over the zero columns; the consumers taking turns on
// named barriers to issue their q k^T, or their p v and the next q k^T (no
// faster, or spilling: the second holds p and the next scores at once).
// Not tried: two consumers of 128 q rows at 240 registers (a third more
// k/v traffic from L2 per q row, one consumer fewer to fill the others'
// softmax gaps, and ptxas sizes consumers by the launch's 168).
//
// At 72 the block runs as a persistent walk (fwd_split_sm90.cuh's Walk;
// d 88 keeps one block a (q block, head)): one block an SM walks (q
// block, head) items with q in two buffers, so the next item's q and
// first kv tiles load behind this item's last tiles and epilogue; where a
// head's kv fits the ring (the text pass's 120 keys: 2 tiles) the block
// walks a run of adjacent items and keeps the tiles across the head's q
// blocks. A 1,024-row head's last block has one live consumer of three,
// and the other two run over their zero q rows as before. Tried on the
// card and dropped (NVIDIA H100 80GB HBM3, 700 W; tools/kernel_ab.py
// against this walk, in the same turns): splitting that block's kv tiles
// three ways over the consumers, with a merge of the partial o and lse
// (Global_Self +5% and spatial +1.5% even with the consumer index made
// warp-uniform by a broadcast; +18% as a second loop; the branch in the
// tile loop costs every item more than the idle consumers cost the
// tail); the two dead consumers letting the tiles pass unread (spatial
// -0.3%, Global_Self +1.8%: a lone consumer is no faster).
//
// K1 at d 64 and 88 folds the q block and b*h into blockIdx.x (the q
// blocks of one head adjacent, so the blocks resident at once share their
// heads' k and v in L2), so b*h may pass gridDim.y's 65,535; the
// persistent kernels walk b*h (V3's temporal pass at 768x768 has b*h =
// 73,728).
//
// Heads of at most 64 q and kv rows at d 144 (V1's and V2's motion
// modules: temporal passes over 36 frames or V1's 2 x 2 cells of 16
// frames) and at d 72 (V3's temporal passes over 36 frames, at q and kv
// rows up to kShortRows) run flash_fwd_short_sm90 (fwd_short_sm90.cuh
// gives its design): a whole head one 64-row wgmma tile, one block an SM
// walking the heads. Every other d 72 shape runs flash_fwd_d72_sm90's
// walk (rows past sq come in as TMA's zeros and are masked); head dims 16
// and 32 (the tiny test preset) and d 144 past 64 q or kv rows run the
// mma.sync body of attn_fwd.cuh. A dispatch by shape in
// ea_flash_fwd_bf16, never a fallback on failure; ea_flash_fwd_uses_sm90
// and ea_flash_fwd_uses_short tell the wrapper which ran.
#include "fwd_short_sm90.cuh"
#include "fwd_split_sm90.cuh"
#include "fwd_sm90.cuh"

namespace ea {
namespace k1 {

using fwd90::kBlockM;
using fwd90::kBlockN;
using fwd90::kConsumerRegs;
using fwd90::kD;
using fwd90::kSmemBytes;
using fwd90::kStages;
using fwd90::kThreads;
using fwd90::Smem;

// One consumer warpgroup: 64 q rows against every kv tile, then the store.
// Within a consumer the products and the softmax run in turn; the other
// consumers' products fill the tensor cores meanwhile.
__device__ __forceinline__ void consume(Smem& sm, const CUtensorMap* tm_o,
                                        float* __restrict__ lse, int c,
                                        int bh, int q0, int sq, int kv_valid,
                                        int n_tiles) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_a = warp * 16 + g;  // this thread's two rows in the 64
  const int r_b = r_a + 8;
  __nv_bfloat16* sq_c = sm.q + c * 64 * kD;  // this consumer's q rows
  const uint64_t desc_q = sm90::desc_sw128(sq_c, 16, 1024);

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  fwd90::RowStats st{-INFINITY, -INFINITY, 0.f, 0.f};

  sm90::mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    sm90::mbar_wait(&sm.full[s], (j / kStages) & 1);
    float sc[64];
    sm90::wgmma_fence();
    fwd90::issue_qk(sc, desc_q, sm.k[s]);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    fwd90::mask_tail(sc, j * kBlockN, kv_valid, t);
    fwd90::softmax_pv(sc, o, st, sm, s, lane);
  }
  fwd90::store_o_lse(o, st, sq_c, tm_o, lse, c, bh, q0, sq, tid, t, r_a, r_b);
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_o,
               float* __restrict__ lse, int sq, int kv_valid) {
  Smem& sm = fwd90::init_smem();
  const int warpgroup = threadIdx.x / 128;
  const int n_qb = (sq + kBlockM - 1) / kBlockM;
  const int bh = blockIdx.x / n_qb;
  const int q0 = (blockIdx.x - bh * n_qb) * kBlockM;
  const int n_tiles = (kv_valid + kBlockN - 1) / kBlockN;
  if (warpgroup == 0) {
    fwd90::produce(sm, &tm_q, &tm_k, &tm_v, q0, bh, 0, n_tiles);
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume(sm, &tm_o, lse, warpgroup - 1, bh, q0, sq, kv_valid, n_tiles);
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int sq, int skv, int kv_valid, cudaStream_t stream) {
  fwd90::Maps m;
  const int err = fwd90::encode_maps(m, q, k, v, o, bh, sq, skv, kv_valid);
  if (err) return err;
  cudaError_t st = cudaFuncSetAttribute(
      flash_fwd_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (st != cudaSuccess) return static_cast<int>(st);
  const dim3 grid(static_cast<unsigned>((sq + kBlockM - 1) / kBlockM) * bh);
  flash_fwd_sm90<<<grid, kThreads, kSmemBytes, stream>>>(
      m.q, m.k, m.v, m.o, static_cast<float*>(lse), sq, kv_valid);
  return static_cast<int>(cudaGetLastError());
}

// One consumer warpgroup at d 88 or 72: K1's consume on
// fwd_split_sm90.cuh's pieces.
template <int D>
__device__ __forceinline__ void consume_split(fwdsplit::Smem<D>& sm,
                                              const fwdsplit::Maps<D>& m,
                                              float* __restrict__ lse, int c,
                                              int bh, int q0, int sq,
                                              int kv_valid, int n_tiles) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_a = warp * 16 + g;  // this thread's two rows in the 64
  const int r_b = r_a + 8;
  const fwdsplit::QDesc dq{
      sm90::desc_sw128(sm.q_lo + c * 64 * fwdsplit::kLoCols, 16, 1024),
      fwdsplit::desc_hi<D>(sm.q_hi + c * 64 * fwdsplit::kHiCols<D>, 16,
                           8 * fwdsplit::kHiRowBytes<D>)};

  float o_lo[32], o_hi[fwdsplit::kHiOut<D> / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_lo[i] = 0.f;
#pragma unroll
  for (int i = 0; i < fwdsplit::kHiOut<D> / 2; ++i) o_hi[i] = 0.f;
  fwd90::RowStats st{-INFINITY, -INFINITY, 0.f, 0.f};

  sm90::mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % fwdsplit::kStages;
    sm90::mbar_wait(&sm.full[s], (j / fwdsplit::kStages) & 1);
    float sc[48];
    sm90::wgmma_fence();
    fwdsplit::issue_qk<D>(sc, dq, sm.k_lo[s], sm.k_hi[s]);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    fwdsplit::mask_tail(sc, j * fwdsplit::kBlockN, kv_valid, t);
    fwdsplit::softmax_pv<D>(sc, o_lo, o_hi, st, sm, s, lane);
  }
  fwdsplit::store_o_lse<D>(o_lo, o_hi, st, sm, m, lse, c, bh, q0, sq, tid, t,
                           r_a, r_b);
}

// One consumer warpgroup of the persistent walk (d 72): consume_split's
// loop over each of the block's items, q from buffer i % 2; a stage is
// released after its tile's last use (every use, unless the tiles stay in
// the ring across the head's items), q buffer i % 2 once o is stored.
template <int D>
__device__ __forceinline__ void consume_walk(fwdsplit::SmemWalk<D>& sm,
                                             const fwdsplit::Maps<D>& m,
                                             const fwdsplit::Walk& w,
                                             float* __restrict__ lse, int c,
                                             int sq, int kv_valid) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_a = warp * 16 + g;  // this thread's two rows in the 64
  const int r_b = r_a + 8;
  int jt = 0, prev_bh = -1;
  for (int i = 0; i < w.count; ++i) {
    const int bh = w.head(i), q0 = w.q0(i), qb = i & 1;
    if (w.resident && bh == prev_bh) jt -= w.n_tiles;  // the same tiles
    prev_bh = bh;
    const bool release =
        !w.resident || i + 1 == w.count || w.head(i + 1) != bh;
    const fwdsplit::QView qv = sm.q(qb);
    const fwdsplit::QDesc dq{
        sm90::desc_sw128(qv.q_lo + c * 64 * fwdsplit::kLoCols, 16, 1024),
        fwdsplit::desc_hi<D>(qv.q_hi + c * 64 * fwdsplit::kHiCols<D>, 16,
                             8 * fwdsplit::kHiRowBytes<D>)};
    float o_lo[32], o_hi[fwdsplit::kHiOut<D> / 2];
#pragma unroll
    for (int k = 0; k < 32; ++k) o_lo[k] = 0.f;
#pragma unroll
    for (int k = 0; k < fwdsplit::kHiOut<D> / 2; ++k) o_hi[k] = 0.f;
    fwd90::RowStats st{-INFINITY, -INFINITY, 0.f, 0.f};

    sm90::mbar_wait(sm.q_full(qb), (i >> 1) & 1);
    for (int j = 0; j < w.n_tiles; ++j, ++jt) {
      const int s = jt % fwdsplit::kStages;
      // a tile kept in the ring: its load's phase is still the last one
      sm90::mbar_wait(&sm.b.full[s], (jt / fwdsplit::kStages) & 1);
      float sc[48];
      sm90::wgmma_fence();
      fwdsplit::issue_qk<D>(sc, dq, sm.b.k_lo[s], sm.b.k_hi[s]);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      fwdsplit::mask_tail(sc, j * fwdsplit::kBlockN, kv_valid, t);
      fwdsplit::softmax_pv<D, false>(sc, o_lo, o_hi, st, sm.b, s, lane);
      if (release) {
        __syncwarp();
        if (lane == 0) sm90::mbar_arrive(&sm.b.empty[s]);
      }
    }
    fwdsplit::store_o_lse<D>(o_lo, o_hi, st, qv, m, lse, c, bh, q0, sq, tid,
                             t, r_a, r_b);
    if (tid == 0) sm90::mbar_arrive(&sm.q_empty[qb]);  // o stored from it
  }
}

// The block at d 88 or 72: the producer warpgroup, then three consumers;
// one (q block, head) a block, or (kWalk: d 72) the persistent walk over
// the b*h heads' q blocks.
template <int D, bool kWalk>
__device__ __forceinline__ void split_block(const fwdsplit::Maps<D>& m,
                                            float* __restrict__ lse, int bh,
                                            int sq, int kv_valid) {
  if constexpr (kWalk) {
    fwdsplit::SmemWalk<D>& sm = fwdsplit::init_smem_walk<D>();
    const int warpgroup = threadIdx.x / 128;
    const fwdsplit::Walk w(bh, sq, kv_valid);
    if (warpgroup == 0) {
      fwdsplit::produce_walk<D>(sm, m, w);
    } else {
      sm90::setmaxnreg_inc<fwdsplit::kConsumerRegs>();
      consume_walk<D>(sm, m, w, lse, warpgroup - 1, sq, kv_valid);
    }
  } else {
    fwdsplit::Smem<D>& sm = fwdsplit::init_smem<D>();
    const int warpgroup = threadIdx.x / 128;
    const int n_qb = (sq + fwdsplit::kBlockM - 1) / fwdsplit::kBlockM;
    const int b = blockIdx.x / n_qb;
    const int q0 = (blockIdx.x - b * n_qb) * fwdsplit::kBlockM;
    const int n_tiles = (kv_valid + fwdsplit::kBlockN - 1) / fwdsplit::kBlockN;
    if (warpgroup == 0) {
      fwdsplit::produce<D>(sm, m, q0, b, n_tiles);
    } else {
      sm90::setmaxnreg_inc<fwdsplit::kConsumerRegs>();
      consume_split<D>(sm, m, lse, warpgroup - 1, b, q0, sq, kv_valid,
                       n_tiles);
    }
  }
}

__global__ void __launch_bounds__(fwdsplit::kThreads, 1)
flash_fwd_d88_sm90(const __grid_constant__ fwdsplit::Maps<88> m,
                   float* __restrict__ lse, int sq, int kv_valid) {
  split_block<88, false>(m, lse, 0, sq, kv_valid);
}

__global__ void __launch_bounds__(fwdsplit::kThreads, 1)
flash_fwd_d72_sm90(const __grid_constant__ fwdsplit::Maps<72> m,
                   float* __restrict__ lse, int bh, int sq, int kv_valid) {
  split_block<72, true>(m, lse, bh, sq, kv_valid);
}

// The card's SM count (the persistent kernels' grid), or 0 on an error.
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return n;
}

// Refuses the launch (cudaErrorInvalidConfiguration) unless ptxas gave the
// kernel the 128 registers its setmaxnreg balance assumes. d 88: one block
// a (q block, head); d 72: the persistent walk, one block an SM (or an
// item, if fewer).
template <int D>
int launch_split(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int sq, int skv, int kv_valid,
                 cudaStream_t stream) {
  fwdsplit::Maps<D> m;
  int err = fwdsplit::encode_maps<D>(m, q, k, v, o, bh, sq, skv, kv_valid);
  if (err) return err;
  constexpr bool kWalk = D == 72;
  const auto kernel = kWalk ? reinterpret_cast<const void*>(flash_fwd_d72_sm90)
                            : reinterpret_cast<const void*>(flash_fwd_d88_sm90);
  err = sm90::check_launch_regs(kernel, fwdsplit::kLaunchRegs);
  if (err) return err;
  const size_t smem = kWalk ? fwdsplit::kSmemWalkBytes<D>
                            : fwdsplit::kSmemBytes<D>;
  cudaError_t st = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (st != cudaSuccess) return static_cast<int>(st);
  const long long items =
      (long long)((sq + fwdsplit::kBlockM - 1) / fwdsplit::kBlockM) * bh;
  if constexpr (kWalk) {
    const int sms = sm_count();
    if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
    const dim3 grid(static_cast<unsigned>(items < sms ? items : sms));
    flash_fwd_d72_sm90<<<grid, fwdsplit::kThreads, smem, stream>>>(
        m, static_cast<float*>(lse), bh, sq, kv_valid);
  } else {
    flash_fwd_d88_sm90<<<dim3(static_cast<unsigned>(items)),
                         fwdsplit::kThreads, smem, stream>>>(
        m, static_cast<float*>(lse), sq, kv_valid);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 at d 144 and 72 on heads of at most 64 q and kv rows (fwd_short_sm90.cuh
// gives the design): one block an SM walking the heads.
template <int D>
__global__ void __launch_bounds__(fwdshort::kThreads, 1)
flash_fwd_short_sm90(const __grid_constant__ fwdshort::Maps m,
                     float* __restrict__ lse, int bh, int sq, int kv_valid) {
  fwdshort::Smem<D>& sm = fwdshort::init_smem<D>();
  const int n_heads = (bh - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int warp = threadIdx.x / 32;
  if (warp == fwdshort::kProducerWarp) {
    if (threadIdx.x % 32 == 0) {
      fwdshort::produce<D>(sm, m, blockIdx.x, gridDim.x, n_heads);
    }
  } else {
    fwdshort::consume<D>(sm, m, lse, warp / 4, blockIdx.x, gridDim.x,
                         n_heads, sq, kv_valid);
  }
}

template <int D>
int launch_short(const void* q, const void* k, const void* v, void* o,
                 void* lse, int bh, int sq, int skv, int kv_valid,
                 cudaStream_t stream) {
  fwdshort::Maps m;
  int err = fwdshort::encode_maps<D>(m, q, k, v, o, bh, sq, skv, kv_valid);
  if (err) return err;
  constexpr size_t smem = fwdshort::kSmemBytes<D>;
  cudaError_t st = cudaFuncSetAttribute(
      flash_fwd_short_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (st != cudaSuccess) return static_cast<int>(st);
  const int sms = sm_count();
  if (sms == 0) return static_cast<int>(cudaErrorInvalidDevice);
  const dim3 grid(static_cast<unsigned>(bh < sms ? bh : sms));
  flash_fwd_short_sm90<D><<<grid, fwdshort::kThreads, smem, stream>>>(
      m, static_cast<float*>(lse), bh, sq, kv_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k1
}  // namespace ea

// q and kv rows at or below which d 72 takes flash_fwd_short_sm90 rather
// than flash_fwd_d72_sm90's walk (V3's temporal passes over 36 latent
// frames). On an H100 80GB HBM3 (700 W) at 1.18 M q rows,
// tools/k1_d72_crossover.py: the short-head kernel 0.273 / 0.253 ms at
// 36 / 64 rows against the walk's 0.67 / 0.40
constexpr int kShortRows = 64;
static_assert(kShortRows <= ea::fwdshort::kRows, "one wgmma tile a head");

// Heads of at most 64 q and kv rows at d 144, and at d 72 up to
// kShortRows: flash_fwd_short_sm90.
static bool short_route(int head_dim, int sq, int skv) {
  const int rows = head_dim == 144 ? ea::fwdshort::kRows
                   : head_dim == 72 ? kShortRows
                                    : 0;
  return sq <= rows && skv <= rows;
}

extern "C" int ea_flash_fwd_uses_short(int head_dim, int sq, int skv) {
  return short_route(head_dim, sq, skv);
}

extern "C" int ea_flash_fwd_uses_sm90(int head_dim, int sq, int skv) {
  return head_dim == ea::fwd90::kD || head_dim == 88 || head_dim == 72 ||
         short_route(head_dim, sq, skv);
}

extern "C" int ea_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int sq, int skv,
                                 int kv_valid, int head_dim, void* stream) {
  const cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (head_dim == ea::fwd90::kD) {
    return ea::k1::launch(q, k, v, o, lse, bh, sq, skv, kv_valid, st);
  }
  if (head_dim == 88) {
    return ea::k1::launch_split<88>(q, k, v, o, lse, bh, sq, skv, kv_valid,
                                    st);
  }
  // a dispatch by shape; the wrapper's launches_sm90 and launches_short
  // counts read the same predicates
  if (short_route(head_dim, sq, skv)) {
    return head_dim == 144
               ? ea::k1::launch_short<144>(q, k, v, o, lse, bh, sq, skv,
                                           kv_valid, st)
               : ea::k1::launch_short<72>(q, k, v, o, lse, bh, sq, skv,
                                          kv_valid, st);
  }
  if (head_dim == 72) {
    return ea::k1::launch_split<72>(q, k, v, o, lse, bh, sq, skv, kv_valid,
                                    st);
  }
  return ea::launch_attn_fwd<false>(q, k, v, o, lse, bh, sq, skv, kv_valid,
                                    /*window=*/0, head_dim, stream);
}
