// The pieces of K1's TMA + wgmma forward-attention block at head_dim 88
// (V4's HunyuanDiT; flash_fwd.cu's note gives the design): the tile shape
// and register split, the shared-memory layout, the producer's loads, the
// two products, the online base-2 softmax of one tile, the tail mask and
// the epilogue. It is fwd_sm90.cuh's block (K1 at d 64) with each row cut
// in two, kept apart from that header so that K1, K2 and K5 at d 64
// compile as they did.
//
// A row of 88 bf16 is 176 bytes, more than one 128-byte swizzle span. Every
// q, k, v and o tile is therefore two TMA boxes over the same [bh, S, 88]
// tensor, whose maps take 88 as the column extent:
//   - "lo": columns 0-63, rows of 128 bytes, 128-byte swizzle (as at d 64);
//   - "hi": columns 64-95, rows of 64 bytes, 64-byte swizzle; TMA fills
//     columns 88-95 with zeros in shared memory (they lie past the map's
//     extent), so nothing is padded in global memory, and a store clips
//     them. A map declared 96 columns wide would read the next row's first
//     8 values there instead.
// q k^T takes four k16 steps over lo and two over hi (the zero columns add
// nothing); p v one n64 product over lo's columns and one n24 over the
// first 24 of hi's, so no product runs over columns 88-95.
//
// Head dim 72 (V1-V3) is the same block with a 16-column hi part (rows of
// 32 bytes, 32-byte swizzle, one k16 step of q k^T, an n8 p v): the hi
// constants below and one more wgmma wrapper.
#pragma once

#include "fwd_sm90.cuh"
#include "hopper.cuh"

namespace ea {
namespace fwd88 {

constexpr int kD = 88;                       // head_dim of the block
constexpr int kLoCols = 64;                  // columns 0-63
constexpr int kHiCols = 32;                  // columns 64-95 (88-95 zero)
constexpr int kHiOut = kD - kLoCols;         // p v's columns 64-87
constexpr int kConsumers = 3;                // consumer warpgroups
constexpr int kBlockM = 64 * kConsumers;     // q rows per block
constexpr int kBlockN = 96;                  // kv rows per stage
constexpr int kStages = 4;
constexpr int kThreads = 128 * (kConsumers + 1);
// registers a thread, as at d 64: the launch gives 65536 / 512 = 128; the
// producer's 128 x (128 - 32) given back are the consumers' 384 x (160 -
// 128). ptxas fits the consumers into the launch's 128: o (32 + 12), the
// scores (48) and p (24) of a 96-row kv tile
constexpr int kLaunchRegs = 128;
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
constexpr int kLoRowBytes = kLoCols * 2;     // 128
constexpr int kHiRowBytes = kHiCols * 2;     // 64
constexpr uint32_t kQBytes = kBlockM * (kLoRowBytes + kHiRowBytes);
constexpr uint32_t kTileBytes = kBlockN * (kLoRowBytes + kHiRowBytes);

// Every array starts 1024-byte aligned (each is a multiple of 1024 bytes):
// the 128-byte swizzle's atom, and twice the 64-byte swizzle's.
struct Smem {
  __nv_bfloat16 q_lo[kBlockM * kLoCols];
  __nv_bfloat16 q_hi[kBlockM * kHiCols];
  __nv_bfloat16 k_lo[kStages][kBlockN * kLoCols];
  __nv_bfloat16 k_hi[kStages][kBlockN * kHiCols];
  __nv_bfloat16 v_lo[kStages][kBlockN * kLoCols];
  __nv_bfloat16 v_hi[kStages][kBlockN * kHiCols];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

using fwd90::RowStats;
using sm90::fast_exp2;

__device__ __forceinline__ Smem& init_smem() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::smem_u32(smem_raw);
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + (((base + 1023) & ~1023u) - base));
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
struct Maps {
  CUtensorMap q_lo, q_hi, k_lo, k_hi, v_lo, v_hi, o_lo, o_hi;
};

// One tensor's two maps over [bh, *, 88] with head_rows rows a head, of
// which the first `rows` are read (rows past them arrive as zeros).
inline int encode_pair(CUtensorMap* lo, CUtensorMap* hi, const void* base,
                       int rows, int head_rows, int bh, int box_rows) {
  const uint64_t head = (uint64_t)head_rows * kD * 2;
  int err = sm90::encode_rows(lo, base, kD, rows, bh, head, kLoCols, box_rows,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = sm90::encode_rows(hi, base, kD, rows, bh, head, kHiCols,
                                    box_rows, CU_TENSOR_MAP_SWIZZLE_64B);
  return err;
}

inline int encode_maps(Maps& m, const void* q, const void* k, const void* v,
                       void* o, int bh, int sq, int skv, int kv_rows) {
  int err = encode_pair(&m.q_lo, &m.q_hi, q, sq, sq, bh, kBlockM);
  if (!err) err = encode_pair(&m.k_lo, &m.k_hi, k, kv_rows, skv, bh, kBlockN);
  if (!err) err = encode_pair(&m.v_lo, &m.v_hi, v, kv_rows, skv, bh, kBlockN);
  if (!err) err = encode_pair(&m.o_lo, &m.o_hi, o, sq, sq, bh, 64);
  return err;
}

// The producer warpgroup: one thread loads the block's q rows once, then
// n_tiles k and v tiles of kBlockN rows through the ring. Each stage's
// transaction count is the four boxes' full bytes, TMA's zero-filled
// columns 88-95 included.
__device__ __forceinline__ void produce(Smem& sm, const Maps& m, int q0,
                                        int bh, int n_tiles) {
  sm90::setmaxnreg_dec<kProducerRegs>();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(&sm.q_full, kQBytes);
    sm90::tma_load_3d(sm.q_lo, &m.q_lo, &sm.q_full, 0, q0, bh);
    sm90::tma_load_3d(sm.q_hi, &m.q_hi, &sm.q_full, kLoCols, q0, bh);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int row = j * kBlockN;
      // the first pass over the ring finds every stage free
      sm90::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes);
      sm90::tma_load_3d(sm.k_lo[s], &m.k_lo, &sm.full[s], 0, row, bh);
      sm90::tma_load_3d(sm.k_hi[s], &m.k_hi, &sm.full[s], kLoCols, row, bh);
      sm90::tma_load_3d(sm.v_lo[s], &m.v_lo, &sm.full[s], 0, row, bh);
      sm90::tma_load_3d(sm.v_hi[s], &m.v_hi, &sm.full[s], kLoCols, row, bh);
    }
  }
}

// A consumer's q descriptors: its 64 rows of q_lo (128-byte swizzle, 8-row
// groups 1024 bytes apart) and of q_hi (64-byte swizzle, 512 bytes apart).
struct QDesc {
  uint64_t lo, hi;
};

// s = q k^T for one kv tile: four k steps of 16 over columns 0-63 and two
// over 64-95 (32 bytes along the rows of both operands each), committed as
// one group.
__device__ __forceinline__ void issue_qk(float (&sc)[48], const QDesc& dq,
                                         const __nv_bfloat16* k_lo,
                                         const __nv_bfloat16* k_hi) {
  const uint64_t dk_lo = sm90::desc_sw128(k_lo, 16, 1024);
  const uint64_t dk_hi = sm90::desc_sw64(k_hi, 16, 512);
#pragma unroll
  for (int kk = 0; kk < kLoCols / 16; ++kk) {
    sm90::wgmma_m64n96k16_ss(sc, dq.lo + 2 * kk, dk_lo + 2 * kk, kk);
  }
#pragma unroll
  for (int kk = 0; kk < kHiCols / 16; ++kk) {
    sm90::wgmma_m64n96k16_ss(sc, dq.hi + 2 * kk, dk_hi + 2 * kk, 1);
  }
  sm90::wgmma_commit();
}

// o += p v over half a kv tile: k steps ks0..ks0+2 take p's columns
// 16ks..16ks+15 from registers and v's rows 16ks..16ks+15, MN-major (2048
// bytes further on in v_lo, 1024 in v_hi), into o_lo (columns 0-63) and
// o_hi (64-87: an n24 product reads the first 24 columns of v_hi's
// 32-column swizzled rows), committed as one group.
__device__ __forceinline__ void issue_pv_half(float (&o_lo)[32],
                                              float (&o_hi)[kHiOut / 2],
                                              const uint32_t (&pa)[kBlockN / 16][4],
                                              int ks0,
                                              const __nv_bfloat16* v_lo,
                                              const __nv_bfloat16* v_hi) {
  const uint64_t dv_lo = sm90::desc_sw128(v_lo, 1024, 1024);
  const uint64_t dv_hi = sm90::desc_sw64(v_hi, 512, 512);
#pragma unroll
  for (int ks = ks0; ks < ks0 + kBlockN / 32; ++ks) {
    sm90::wgmma_m64n64k16_rs_tb(o_lo, pa[ks],
                                dv_lo + ks * (16 * kLoRowBytes >> 4), 1);
    sm90::wgmma_m64n24k16_rs_tb(o_hi, pa[ks],
                                dv_hi + ks * (16 * kHiRowBytes >> 4), 1);
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
// wgmma.wait_group shows both complete.
__device__ __forceinline__ void softmax_pv(float (&sc)[48], float (&o_lo)[32],
                                           float (&o_hi)[kHiOut / 2], RowStats& st,
                                           Smem& sm, int s, int lane) {
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
    for (int i = 0; i < kHiOut / 8; ++i) {
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
    issue_pv_half(o_lo, o_hi, pa, h * kBlockN / 32, sm.v_lo[s], sm.v_hi[s]);
  }
  st.l_a = st.l_a * alpha_a + sum_a;
  st.l_b = st.l_b * alpha_b + sum_b;
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o_lo);
  sm90::fence_regs(o_hi);
  sm90::fence_regs(pa);
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);  // k and v of stage s read
}

// A consumer's epilogue: o * (1 / l) in bf16 written into its own q rows
// (all its q k^T products are done) in the swizzled layouts the o maps
// store from, then two TMA stores of its 64 rows from q0 + 64 c: columns
// 0-63 and 64-95 (the store clips columns >= 88 and rows >= sq); lse = m +
// log2(l) for rows below sq. tid, t, r_a and r_b are the consumer thread's
// index in its warpgroup, in its quad, and its two rows in the 64.
__device__ __forceinline__ void store_o_lse(const float (&o_lo)[32],
                                            const float (&o_hi)[kHiOut / 2],
                                            const RowStats& st, Smem& sm,
                                            const Maps& m,
                                            float* __restrict__ lse, int c,
                                            int bh, int q0, int sq, int tid,
                                            int t, int r_a, int r_b) {
  const float l_sum_a = fwd90::quad_sum(st.l_a);
  const float l_sum_b = fwd90::quad_sum(st.l_b);
  // 1/l, or 1 for a row that saw nothing (its o is 0)
  const float inv_a = l_sum_a <= 0.f ? 1.f : 1.f / l_sum_a;
  const float inv_b = l_sum_b <= 0.f ? 1.f : 1.f / l_sum_b;
  uint8_t* so_lo = reinterpret_cast<uint8_t*>(sm.q_lo + c * 64 * kLoCols);
  uint8_t* so_hi = reinterpret_cast<uint8_t*>(sm.q_hi + c * 64 * kHiCols);
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
  // hi: chunk i of row r sits at chunk i ^ ((r / 2) % 4); (r_b / 2) % 4 ==
  // (r_a / 2) % 4. Chunk 3 (columns 88-95) is clipped by the store
#pragma unroll
  for (int i = 0; i < kHiOut / 8; ++i) {
    const int off = ((i ^ ((r_a >> 1) & 3)) << 4) + 4 * t;
    *reinterpret_cast<uint32_t*>(so_hi + r_a * kHiRowBytes + off) =
        pack_f32(o_hi[4 * i] * inv_a, o_hi[4 * i + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(so_hi + r_b * kHiRowBytes + off) =
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

}  // namespace fwd88
}  // namespace ea
