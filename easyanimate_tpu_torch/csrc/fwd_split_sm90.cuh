// The pieces of K1's TMA + wgmma forward-attention block at head dims 88
// (V4's HunyuanDiT) and 72 (the V1-V3 Transformer3D; flash_fwd.cu's note
// gives the design): the tile shape and register split, the shared-memory
// layout, the producer's loads, the two products, the online base-2
// softmax of one tile, the tail mask and the epilogue. It is fwd_sm90.cuh's
// block (K1 at d 64) with each row cut in two, kept apart from that header
// so that K1, K2 and K5 at d 64 compile as they did.
//
// A row of D bf16 is more than 128 bytes, one 128-byte swizzle span. Every
// q, k, v and o tile is therefore two TMA boxes over the same [bh, S, D]
// tensor, whose maps take D as the column extent:
//   - "lo": columns 0-63, rows of 128 bytes, 128-byte swizzle (as at d 64);
//   - "hi": the next Split<D>::kHiCols columns, the smallest swizzle span
//     that holds D - 64 of them: at d 88 columns 64-95 (rows of 64 bytes,
//     64-byte swizzle), at d 72 columns 64-79 (rows of 32 bytes, 32-byte
//     swizzle). TMA fills the columns past D with zeros in shared memory
//     (they lie past the map's extent), so nothing is padded in global
//     memory, and a store clips them. A map declared wider than D would read
//     the next row's first values there instead.
// q k^T takes four k16 steps over lo and kHiCols / 16 over hi (the zero
// columns add nothing); p v one n64 product over lo's columns and one of n
// = D - 64 over the first columns of hi (n24 at 88, n8 at 72), so no
// product runs over the zero columns.
#pragma once

#include "fwd_sm90.cuh"
#include "hopper.cuh"

namespace ea {
namespace fwdsplit {

// The hi box of a row of D columns: its width and its swizzle.
template <int D>
struct Split;

template <>
struct Split<88> {
  static constexpr int kHiCols = 32;  // columns 64-95 (88-95 zero)
  static constexpr CUtensorMapSwizzle kHiSwizzle = CU_TENSOR_MAP_SWIZZLE_64B;
};

template <>
struct Split<72> {
  static constexpr int kHiCols = 16;  // columns 64-79 (72-79 zero)
  static constexpr CUtensorMapSwizzle kHiSwizzle = CU_TENSOR_MAP_SWIZZLE_32B;
};

constexpr int kLoCols = 64;                  // columns 0-63
constexpr int kConsumers = 3;                // consumer warpgroups
constexpr int kBlockM = 64 * kConsumers;     // q rows per block
constexpr int kBlockN = 96;                  // kv rows per stage
constexpr int kStages = 4;
constexpr int kThreads = 128 * (kConsumers + 1);
// registers a thread, as at d 64: the launch gives 65536 / 512 = 128; the
// producer's 128 x (128 - 32) given back are the consumers' 384 x (160 -
// 128). ptxas fits the consumers into the launch's 128: at d 88 o (32 +
// 12), the scores (48) and p (24) of a 96-row kv tile; at d 72 o takes 32 +
// 4
constexpr int kLaunchRegs = 128;
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
constexpr int kLoRowBytes = kLoCols * 2;     // 128

template <int D>
constexpr int kHiCols = Split<D>::kHiCols;
template <int D>
constexpr int kHiOut = D - kLoCols;          // p v's columns 64..D-1
template <int D>
constexpr int kHiRowBytes = kHiCols<D> * 2;  // 64 at d 88, 32 at d 72
template <int D>
constexpr uint32_t kQBytes = kBlockM * (kLoRowBytes + kHiRowBytes<D>);
template <int D>
constexpr uint32_t kTileBytes = kBlockN * (kLoRowBytes + kHiRowBytes<D>);

// Every array starts 1024-byte aligned (each is a multiple of 1024 bytes):
// the 128-byte swizzle's atom, and a multiple of the narrower ones'.
template <int D>
struct Smem {
  __nv_bfloat16 q_lo[kBlockM * kLoCols];
  __nv_bfloat16 q_hi[kBlockM * kHiCols<D>];
  __nv_bfloat16 k_lo[kStages][kBlockN * kLoCols];
  __nv_bfloat16 k_hi[kStages][kBlockN * kHiCols<D>];
  __nv_bfloat16 v_lo[kStages][kBlockN * kLoCols];
  __nv_bfloat16 v_hi[kStages][kBlockN * kHiCols<D>];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};
template <int D>
constexpr size_t kSmemBytes = sizeof(Smem<D>) + 1024;  // + alignment slack

using fwd90::RowStats;
using sm90::fast_exp2;

// A descriptor of a hi tile (swizzled as its map loads it): rows of 64
// bytes at d 88, of 32 at d 72.
template <int D>
__device__ __forceinline__ uint64_t desc_hi(const void* tile,
                                            uint32_t lbo_bytes,
                                            uint32_t sbo_bytes) {
  if constexpr (kHiCols<D> == 32) {
    return sm90::desc_sw64(tile, lbo_bytes, sbo_bytes);
  } else {
    return sm90::desc_sw32(tile, lbo_bytes, sbo_bytes);
  }
}

// Where the 16-byte chunk i of hi row r sits in its swizzled row: the
// swizzle XORs the chunk index with the address bits 7 and up, which a
// row of 64 bytes reaches at r / 2 and one of 32 bytes at r / 4.
template <int D>
__device__ __forceinline__ int hi_chunk(int i, int r) {
  if constexpr (kHiCols<D> == 32) {
    return i ^ ((r >> 1) & 3);
  } else {
    return i ^ ((r >> 2) & 1);
  }
}

template <int D>
__device__ __forceinline__ Smem<D>& init_smem() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::smem_u32(smem_raw);
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      smem_raw + (((base + 1023) & ~1023u) - base));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.full[s], 1);                // the producer's arrive
      sm90::mbar_init(&sm.empty[s], kConsumers * 4);  // one per consumer warp
    }
    sm90::mbar_init(&sm.q_full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

// A launch's tensor maps, each tensor's lo and hi boxes: q and o over sq
// rows, in boxes of the block's rows and a consumer's 64; k and v over
// kv_rows rows (rows at or past it read as zeros, so no tile reads another
// head's rows), in boxes of kBlockN.
template <int D>
struct Maps {
  CUtensorMap q_lo, q_hi, k_lo, k_hi, v_lo, v_hi, o_lo, o_hi;
};

// One tensor's two maps over [bh, *, D] with head_rows rows a head, of
// which the first `rows` are read (rows past them arrive as zeros).
template <int D>
inline int encode_pair(CUtensorMap* lo, CUtensorMap* hi, const void* base,
                       int rows, int head_rows, int bh, int box_rows) {
  const uint64_t head = (uint64_t)head_rows * D * 2;
  int err = sm90::encode_rows(lo, base, D, rows, bh, head, kLoCols, box_rows,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = sm90::encode_rows(hi, base, D, rows, bh, head, kHiCols<D>,
                                    box_rows, Split<D>::kHiSwizzle);
  return err;
}

template <int D>
inline int encode_maps(Maps<D>& m, const void* q, const void* k,
                       const void* v, void* o, int bh, int sq, int skv,
                       int kv_rows) {
  int err = encode_pair<D>(&m.q_lo, &m.q_hi, q, sq, sq, bh, kBlockM);
  if (!err) err = encode_pair<D>(&m.k_lo, &m.k_hi, k, kv_rows, skv, bh,
                                 kBlockN);
  if (!err) err = encode_pair<D>(&m.v_lo, &m.v_hi, v, kv_rows, skv, bh,
                                 kBlockN);
  if (!err) err = encode_pair<D>(&m.o_lo, &m.o_hi, o, sq, sq, bh, 64);
  return err;
}

// The producer warpgroup: one thread loads the block's q rows once, then
// n_tiles k and v tiles of kBlockN rows through the ring. Each stage's
// transaction count is the four boxes' full bytes, TMA's zero-filled
// columns past D included.
template <int D>
__device__ __forceinline__ void produce(Smem<D>& sm, const Maps<D>& m, int q0,
                                        int bh, int n_tiles) {
  sm90::setmaxnreg_dec<kProducerRegs>();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(&sm.q_full, kQBytes<D>);
    sm90::tma_load_3d(sm.q_lo, &m.q_lo, &sm.q_full, 0, q0, bh);
    sm90::tma_load_3d(sm.q_hi, &m.q_hi, &sm.q_full, kLoCols, q0, bh);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int row = j * kBlockN;
      // the first pass over the ring finds every stage free
      sm90::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes<D>);
      sm90::tma_load_3d(sm.k_lo[s], &m.k_lo, &sm.full[s], 0, row, bh);
      sm90::tma_load_3d(sm.k_hi[s], &m.k_hi, &sm.full[s], kLoCols, row, bh);
      sm90::tma_load_3d(sm.v_lo[s], &m.v_lo, &sm.full[s], 0, row, bh);
      sm90::tma_load_3d(sm.v_hi[s], &m.v_hi, &sm.full[s], kLoCols, row, bh);
    }
  }
}

// A consumer's q descriptors: its 64 rows of q_lo (128-byte swizzle, 8-row
// groups 1024 bytes apart) and of q_hi (8-row groups 8 hi rows apart).
struct QDesc {
  uint64_t lo, hi;
};

// s = q k^T for one kv tile: four k steps of 16 over columns 0-63 and
// kHiCols / 16 over the hi columns (32 bytes along the rows of both
// operands each), committed as one group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[48], const QDesc& dq,
                                         const __nv_bfloat16* k_lo,
                                         const __nv_bfloat16* k_hi) {
  const uint64_t dk_lo = sm90::desc_sw128(k_lo, 16, 1024);
  const uint64_t dk_hi = desc_hi<D>(k_hi, 16, 8 * kHiRowBytes<D>);
#pragma unroll
  for (int kk = 0; kk < kLoCols / 16; ++kk) {
    sm90::wgmma_m64n96k16_ss(sc, dq.lo + 2 * kk, dk_lo + 2 * kk, kk);
  }
#pragma unroll
  for (int kk = 0; kk < kHiCols<D> / 16; ++kk) {
    sm90::wgmma_m64n96k16_ss(sc, dq.hi + 2 * kk, dk_hi + 2 * kk, 1);
  }
  sm90::wgmma_commit();
}

// o_hi += p v over one k step: the first kHiOut columns of v_hi's swizzled
// rows (n24 at d 88, n8 at d 72).
template <int D>
__device__ __forceinline__ void wgmma_pv_hi(float (&o_hi)[kHiOut<D> / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  if constexpr (kHiOut<D> == 24) {
    sm90::wgmma_m64n24k16_rs_tb(o_hi, a, desc_b, 1);
  } else {
    sm90::wgmma_m64n8k16_rs_tb(o_hi, a, desc_b, 1);
  }
}

// o += p v over half a kv tile: k steps ks0..ks0+2 take p's columns
// 16ks..16ks+15 from registers and v's rows 16ks..16ks+15, MN-major (2048
// bytes further on in v_lo, 16 hi rows in v_hi), into o_lo (columns 0-63)
// and o_hi (64..D-1), committed as one group.
template <int D>
__device__ __forceinline__ void issue_pv_half(float (&o_lo)[32],
                                              float (&o_hi)[kHiOut<D> / 2],
                                              const uint32_t (&pa)[kBlockN / 16][4],
                                              int ks0,
                                              const __nv_bfloat16* v_lo,
                                              const __nv_bfloat16* v_hi) {
  const uint64_t dv_lo = sm90::desc_sw128(v_lo, 1024, 1024);
  const uint64_t dv_hi = desc_hi<D>(v_hi, 8 * kHiRowBytes<D>,
                                    8 * kHiRowBytes<D>);
#pragma unroll
  for (int ks = ks0; ks < ks0 + kBlockN / 32; ++ks) {
    sm90::wgmma_m64n64k16_rs_tb(o_lo, pa[ks],
                                dv_lo + ks * (16 * kLoRowBytes >> 4), 1);
    wgmma_pv_hi<D>(o_hi, pa[ks], dv_hi + ks * (16 * kHiRowBytes<D> >> 4));
  }
  sm90::wgmma_commit();
}

// Columns >= kv_valid (col0 is the tile's first) set to -inf on the last
// tile: the zero rows TMA fills in would otherwise score 0.
__device__ __forceinline__ void mask_tail(float (&sc)[48], int col0,
                                          int kv_valid, int t) {
  if (col0 + kBlockN > kv_valid) {  // the last tile
#pragma unroll
    for (int i = 0; i < kBlockN / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col0 + 8 * i + 2 * t + e >= kv_valid) {
          sc[4 * i + e] = -INFINITY;
          sc[4 * i + 2 + e] = -INFINITY;
        }
      }
    }
  }
}

// One tile of a consumer, after its scores are masked: the online base-2
// softmax with the row maxima taken over the whole tile first (so both
// halves share one max), o rescaled (skipped when neither of the thread's
// rows' max moved: alpha is then exactly 1); then for each half of the
// tile's columns, p = exp2(s - m) packed as the A fragments of p v (two
// adjacent 8-column chunks a k step) and that half's p v issued, so that
// the second half's exponentials run while the first half's product is on
// the tensor cores; the stage released (its empty barrier) once
// wgmma.wait_group shows both complete (unless kArrive is false: the
// persistent walk's consumers release a stage themselves, once its last
// use is done).
template <int D, bool kArrive = true>
__device__ __forceinline__ void softmax_pv(float (&sc)[48], float (&o_lo)[32],
                                           float (&o_hi)[kHiOut<D> / 2],
                                           RowStats& st, Smem<D>& sm, int s,
                                           int lane) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int i = 0; i < kBlockN / 8; ++i) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  const float mn_a = fmaxf(st.m_a, fwd90::quad_max(mx_a));
  const float mn_b = fmaxf(st.m_b, fwd90::quad_max(mx_b));
  // a row with nothing visible yet keeps m = -inf; exponentiate against 0
  const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
  const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
  const float alpha_a = fast_exp2(st.m_a - mu_a);
  const float alpha_b = fast_exp2(st.m_b - mu_b);
  st.m_a = mn_a;
  st.m_b = mn_b;
  if (alpha_a != 1.f || alpha_b != 1.f) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      o_lo[4 * i] *= alpha_a;
      o_lo[4 * i + 1] *= alpha_a;
      o_lo[4 * i + 2] *= alpha_b;
      o_lo[4 * i + 3] *= alpha_b;
    }
#pragma unroll
    for (int i = 0; i < kHiOut<D> / 8; ++i) {
      o_hi[4 * i] *= alpha_a;
      o_hi[4 * i + 1] *= alpha_a;
      o_hi[4 * i + 2] *= alpha_b;
      o_hi[4 * i + 3] *= alpha_b;
    }
  }
  sm90::fence_regs(o_lo);  // the rescale lands before the first fence
  sm90::fence_regs(o_hi);
  float sum_a = 0.f, sum_b = 0.f;
  uint32_t pa[kBlockN / 16][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int i = h * kBlockN / 16; i < (h + 1) * kBlockN / 16; ++i) {
      sc[4 * i] = fast_exp2(sc[4 * i] - mu_a);
      sc[4 * i + 1] = fast_exp2(sc[4 * i + 1] - mu_a);
      sc[4 * i + 2] = fast_exp2(sc[4 * i + 2] - mu_b);
      sc[4 * i + 3] = fast_exp2(sc[4 * i + 3] - mu_b);
      sum_a += sc[4 * i] + sc[4 * i + 1];
      sum_b += sc[4 * i + 2] + sc[4 * i + 3];
    }
#pragma unroll
    for (int ks = h * kBlockN / 32; ks < (h + 1) * kBlockN / 32; ++ks) {
      pa[ks][0] = pack_f32(sc[8 * ks], sc[8 * ks + 1]);
      pa[ks][1] = pack_f32(sc[8 * ks + 2], sc[8 * ks + 3]);
      pa[ks][2] = pack_f32(sc[8 * ks + 4], sc[8 * ks + 5]);
      pa[ks][3] = pack_f32(sc[8 * ks + 6], sc[8 * ks + 7]);
      // this half's p lands before the fence (the other half's may be in
      // flight)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(pa[ks][e]) :: "memory");
    }
    sm90::wgmma_fence();
    issue_pv_half<D>(o_lo, o_hi, pa, h * kBlockN / 32, sm.v_lo[s],
                     sm.v_hi[s]);
  }
  st.l_a = st.l_a * alpha_a + sum_a;
  st.l_b = st.l_b * alpha_b + sum_b;
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o_lo);
  sm90::fence_regs(o_hi);
  sm90::fence_regs(pa);
  if constexpr (kArrive) {
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);  // k and v of stage s read
  }
}

// A consumer's epilogue: o * (1 / l) in bf16 written into its own q rows
// (all its q k^T products are done) in the swizzled layouts the o maps
// store from, then two TMA stores of its 64 rows from q0 + 64 c: columns
// 0-63 and the hi box (the store clips columns >= D and rows >= sq); lse =
// m + log2(l) for rows below sq. tid, t, r_a and r_b are the consumer
// thread's index in its warpgroup, in its quad, and its two rows in the 64.
// sm holds the q buffer as q_lo and q_hi: the block's Smem<D>, or the
// persistent walk's QView of one of its two buffers.
template <int D, class S>
__device__ __forceinline__ void store_o_lse(const float (&o_lo)[32],
                                            const float (&o_hi)[kHiOut<D> / 2],
                                            const RowStats& st, S& sm,
                                            const Maps<D>& m,
                                            float* __restrict__ lse, int c,
                                            int bh, int q0, int sq, int tid,
                                            int t, int r_a, int r_b) {
  const float l_sum_a = fwd90::quad_sum(st.l_a);
  const float l_sum_b = fwd90::quad_sum(st.l_b);
  // 1/l, or 1 for a row that saw nothing (its o is 0)
  const float inv_a = l_sum_a <= 0.f ? 1.f : 1.f / l_sum_a;
  const float inv_b = l_sum_b <= 0.f ? 1.f : 1.f / l_sum_b;
  uint8_t* so_lo = reinterpret_cast<uint8_t*>(sm.q_lo + c * 64 * kLoCols);
  uint8_t* so_hi = reinterpret_cast<uint8_t*>(sm.q_hi + c * 64 * kHiCols<D>);
  sm90::named_barrier_sync(1 + c, 128);
  // lo: the 16-byte chunk i of row r sits at chunk i ^ (r % 8);
  // r_b % 8 == r_a % 8
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int off = ((i ^ (r_a & 7)) << 4) + 4 * t;
    *reinterpret_cast<uint32_t*>(so_lo + r_a * kLoRowBytes + off) =
        pack_f32(o_lo[4 * i] * inv_a, o_lo[4 * i + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(so_lo + r_b * kLoRowBytes + off) =
        pack_f32(o_lo[4 * i + 2] * inv_b, o_lo[4 * i + 3] * inv_b);
  }
  // hi: chunk i of row r sits at hi_chunk(i, r), the same for r_a and r_b
  // (8 rows apart). The chunks past column D - 1 are clipped by the store
#pragma unroll
  for (int i = 0; i < kHiOut<D> / 8; ++i) {
    const int off = (hi_chunk<D>(i, r_a) << 4) + 4 * t;
    *reinterpret_cast<uint32_t*>(so_hi + r_a * kHiRowBytes<D> + off) =
        pack_f32(o_hi[4 * i] * inv_a, o_hi[4 * i + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(so_hi + r_b * kHiRowBytes<D> + off) =
        pack_f32(o_hi[4 * i + 2] * inv_b, o_hi[4 * i + 3] * inv_b);
  }
  sm90::fence_proxy_async();
  sm90::named_barrier_sync(1 + c, 128);
  const int row0 = q0 + c * 64;
  if (tid == 0 && row0 < sq) {
    sm90::tma_store_3d(&m.o_lo, so_lo, 0, row0, bh);
    sm90::tma_store_3d(&m.o_hi, so_hi, kLoCols, row0, bh);
    sm90::tma_store_wait();
  }
  if (t == 0) {
    float* lb = lse + (size_t)bh * sq;
    if (row0 + r_a < sq) lb[row0 + r_a] = st.m_a + log2f(fmaxf(l_sum_a, 1e-30f));
    if (row0 + r_b < sq) lb[row0 + r_b] = st.m_b + log2f(fmaxf(l_sum_b, 1e-30f));
  }
}


// ---- the persistent walk (K1 at d 72) ----------------------------------
//
// About one block an SM walks work items, each one q block of 192 rows of
// one head (item w: head w / n_qb, q block w % n_qb; a head's q blocks
// adjacent). q has two buffers, each with a full barrier and an empty one
// (one arrive per consumer, once its o store has read the buffer), so the
// producer loads the next item's q and first kv tiles while the consumers
// finish this item's last tiles and epilogue. Where a head's kv fits in
// the ring (n_tiles <= kStages: the text pass's 120 keys in 2 tiles) the
// block walks a contiguous run of items, and its tiles stay in the ring
// across that head's items: the producer loads them once, the consumers
// release them after the head's last item. Otherwise the block takes
// every gridDim.x-th item, so the items resident at once are adjacent and
// share their heads' k and v in L2, as the one-block-an-item grid did.

// One of the walk's q buffers, as store_o_lse reads it.
struct QView {
  __nv_bfloat16* q_lo;
  __nv_bfloat16* q_hi;
};

// The block's shared memory: Smem<D> (q buffer 0, the kv ring, its
// barriers and q buffer 0's full barrier), then q buffer 1 and the rest.
template <int D>
struct SmemWalk {
  Smem<D> b;
  alignas(1024) __nv_bfloat16 q_lo1[kBlockM * kLoCols];
  __nv_bfloat16 q_hi1[kBlockM * kHiCols<D>];
  uint64_t q_full1;
  uint64_t q_empty[2];

  __device__ __forceinline__ QView q(int qb) {
    return qb ? QView{q_lo1, q_hi1} : QView{b.q_lo, b.q_hi};
  }
  __device__ __forceinline__ uint64_t* q_full(int qb) {
    return qb ? &q_full1 : &b.q_full;
  }
};
template <int D>
constexpr size_t kSmemWalkBytes = sizeof(SmemWalk<D>) + 1024;

template <int D>
__device__ __forceinline__ SmemWalk<D>& init_smem_walk() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::smem_u32(smem_raw);
  SmemWalk<D>& sm = *reinterpret_cast<SmemWalk<D>*>(
      smem_raw + (((base + 1023) & ~1023u) - base));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&sm.b.full[s], 1);                // the producer's
      sm90::mbar_init(&sm.b.empty[s], kConsumers * 4);  // a consumer warp's
    }
    sm90::mbar_init(&sm.b.q_full, 1);
    sm90::mbar_init(&sm.q_full1, 1);
    sm90::mbar_init(&sm.q_empty[0], kConsumers);  // a consumer's, after its store
    sm90::mbar_init(&sm.q_empty[1], kConsumers);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

// A block's items: first, first + step, ... (count of them); the producer
// and the consumers compute the same walk.
struct Walk {
  int first, step, count, n_qb, n_tiles;
  bool resident;  // kv tiles kept in the ring across a head's items

  __device__ __forceinline__ Walk(int bh, int sq, int kv_valid) {
    n_qb = (sq + kBlockM - 1) / kBlockM;
    n_tiles = (kv_valid + kBlockN - 1) / kBlockN;
    resident = n_tiles <= kStages;
    const long long items = (long long)n_qb * bh;
    if (resident) {
      first = static_cast<int>(items * blockIdx.x / gridDim.x);
      count = static_cast<int>(items * (blockIdx.x + 1) / gridDim.x) - first;
      step = 1;
    } else {
      first = blockIdx.x;
      step = gridDim.x;
      count = static_cast<int>((items - blockIdx.x + gridDim.x - 1) /
                               gridDim.x);
    }
  }
  __device__ __forceinline__ int head(int i) const {
    return (first + i * step) / n_qb;
  }
  __device__ __forceinline__ int q0(int i) const {
    return (first + i * step) % n_qb * kBlockM;
  }
};

// The producer warpgroup: one thread walks the block's items, loading
// each one's q into buffer i % 2 and, unless they are still in the ring,
// its head's kv tiles (jt counts the tiles loaded, as the consumers do).
template <int D>
__device__ __forceinline__ void produce_walk(SmemWalk<D>& sm, const Maps<D>& m,
                                             const Walk& w) {
  sm90::setmaxnreg_dec<kProducerRegs>();
  if (threadIdx.x == 0) {
    int jt = 0, prev_bh = -1;
    for (int i = 0; i < w.count; ++i) {
      const int bh = w.head(i), q0 = w.q0(i), qb = i & 1;
      const QView qv = sm.q(qb);
      // the first pass over each buffer finds it free
      sm90::mbar_wait(&sm.q_empty[qb], ((i >> 1) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(sm.q_full(qb), kQBytes<D>);
      sm90::tma_load_3d(qv.q_lo, &m.q_lo, sm.q_full(qb), 0, q0, bh);
      sm90::tma_load_3d(qv.q_hi, &m.q_hi, sm.q_full(qb), kLoCols, q0, bh);
      if (w.resident && bh == prev_bh) continue;
      prev_bh = bh;
      for (int j = 0; j < w.n_tiles; ++j, ++jt) {
        const int s = jt % kStages;
        const int row = j * kBlockN;
        sm90::mbar_wait(&sm.b.empty[s], ((jt / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&sm.b.full[s], 2 * kTileBytes<D>);
        sm90::tma_load_3d(sm.b.k_lo[s], &m.k_lo, &sm.b.full[s], 0, row, bh);
        sm90::tma_load_3d(sm.b.k_hi[s], &m.k_hi, &sm.b.full[s], kLoCols, row,
                          bh);
        sm90::tma_load_3d(sm.b.v_lo[s], &m.v_lo, &sm.b.full[s], 0, row, bh);
        sm90::tma_load_3d(sm.b.v_hi[s], &m.v_hi, &sm.b.full[s], kLoCols, row,
                          bh);
      }
    }
  }
}

}  // namespace fwdsplit
}  // namespace ea
