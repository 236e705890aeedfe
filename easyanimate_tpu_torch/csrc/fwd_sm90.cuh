// The pieces of K1's TMA + wgmma forward-attention block at head_dim 64
// (flash_fwd.cu's note gives the design) that K2 (swa_fwd.cu) and K5
// (swa_fused_fwd.cu) run too: the tile shape and register split, the
// shared-memory layout, the barriers and the producer's loads, the two
// products, the online base-2 softmax of one tile, the two masks and the
// epilogue. What differs between them is which kv rows a block walks and
// which scores it hides, so each kernel keeps its own consumer loop: K1's
// walks kv rows [0, kv_valid) and masks its last tile, K2's walks the rows
// its q rows can see and masks the band's edge tiles, K5's walks K2's band
// and then K1's global rows. (One consumer loop templated on the walk grew
// K1's spills from 16 to 24 bytes a direction; with the loops apart K1
// keeps its 128 registers, its 16 bytes and its time.)
#pragma once

#include "attn_fwd.cuh"
#include "hopper.cuh"

namespace ea {
namespace fwd90 {

constexpr int kD = 64;                       // head_dim of the block
constexpr int kConsumers = 3;                // consumer warpgroups
constexpr int kBlockM = 64 * kConsumers;     // q rows per block
constexpr int kBlockN = 128;                 // kv rows per stage
constexpr int kStages = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
// registers a thread: the launch gives 65536 / 512 = 128; the producer's
// 128 x (128 - 32) given back are the consumers' 384 x (160 - 128)
constexpr int kLaunchRegs = 128;
constexpr int kProducerRegs = 32;
constexpr int kConsumerRegs = 160;
constexpr int kRowBytes = kD * 2;            // one bf16 row: 128 bytes
constexpr uint32_t kQBytes = kBlockM * kRowBytes;
constexpr uint32_t kTileBytes = kBlockN * kRowBytes;

// Every tile starts 1024-byte aligned (the 128-byte swizzle's atom).
struct Smem {
  __nv_bfloat16 q[kBlockM * kD];
  __nv_bfloat16 k[kStages][kBlockN * kD];
  __nv_bfloat16 v[kStages][kBlockN * kD];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

using sm90::fast_exp2;

// The block's shared memory, 1024-byte aligned, with its barriers
// initialised (one thread, then the whole block synchronised).
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

// The producer warpgroup: one thread loads the block's q rows once, then
// n_tiles k and v tiles of kBlockN rows from kv row kv_begin on (any row: a
// TMA box need not start aligned) through the ring. The consumers count the
// same tiles, as the mbarrier parities need.
__device__ __forceinline__ void produce(Smem& sm, const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int q0, int bh,
                                        int kv_begin, int n_tiles) {
  sm90::setmaxnreg_dec<kProducerRegs>();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(&sm.q_full, kQBytes);
    sm90::tma_load_3d(sm.q, tm_q, &sm.q_full, 0, q0, bh);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      // the first pass over the ring finds every stage free
      sm90::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes);
      sm90::tma_load_3d(sm.k[s], tm_k, &sm.full[s], 0, kv_begin + j * kBlockN, bh);
      sm90::tma_load_3d(sm.v[s], tm_v, &sm.full[s], 0, kv_begin + j * kBlockN, bh);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A consumer thread's running max and partial sum of its two rows.
struct RowStats {
  float m_a, m_b, l_a, l_b;
};

// s = q k^T for one kv tile: 4 k steps of 16 over d (32 bytes along the
// 128-byte rows of both operands), committed as one group.
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint64_t desc_q,
                                         const __nv_bfloat16* k_tile) {
  const uint64_t desc_k = sm90::desc_sw128(k_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    sm90::wgmma_m64n128k16_ss(sc, desc_q + 2 * kk, desc_k + 2 * kk, kk);
  }
  sm90::wgmma_commit();
}

// o += p v for one kv tile: k step ks takes p's columns 16ks..16ks+15 from
// registers and v's rows 16ks..16ks+15 (2048 bytes further on), committed
// as one group.
__device__ __forceinline__ void issue_pv(float (&o)[32],
                                         const uint32_t (&pa)[8][4],
                                         const __nv_bfloat16* v_tile) {
  const uint64_t desc_v = sm90::desc_sw128(v_tile, 1024, 1024);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    sm90::wgmma_m64n64k16_rs_tb(o, pa[ks], desc_v + ks * (16 * kRowBytes >> 4),
                                1);
  }
  sm90::wgmma_commit();
}

// The online base-2 softmax of one tile's scores (hidden ones already
// -inf), in place: the row maxima folded into st.m, the scores turned into
// p = exp2(s - m) and summed into st.l. Returns in alpha_* the factors o
// must be scaled by before this tile's p v.
__device__ __forceinline__ void online_softmax(float (&sc)[64], RowStats& st,
                                               float& alpha_a, float& alpha_b) {
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * i], sc[4 * i + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
  }
  const float mn_a = fmaxf(st.m_a, quad_max(mx_a));
  const float mn_b = fmaxf(st.m_b, quad_max(mx_b));
  // a row with nothing visible yet keeps m = -inf; exponentiate against 0
  const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
  const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
  alpha_a = fast_exp2(st.m_a - mu_a);
  alpha_b = fast_exp2(st.m_b - mu_b);
  st.m_a = mn_a;
  st.m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    sc[4 * i] = fast_exp2(sc[4 * i] - mu_a);
    sc[4 * i + 1] = fast_exp2(sc[4 * i + 1] - mu_a);
    sc[4 * i + 2] = fast_exp2(sc[4 * i + 2] - mu_b);
    sc[4 * i + 3] = fast_exp2(sc[4 * i + 3] - mu_b);
    sum_a += sc[4 * i] + sc[4 * i + 1];
    sum_b += sc[4 * i + 2] + sc[4 * i + 3];
  }
  st.l_a = st.l_a * alpha_a + sum_a;
  st.l_b = st.l_b * alpha_b + sum_b;
}

// p as the A fragments of p v: the scores of two adjacent 8-column chunks
// (columns 16ks..16ks+15) form k step ks.
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    pa[ks][0] = pack_f32(sc[8 * ks], sc[8 * ks + 1]);
    pa[ks][1] = pack_f32(sc[8 * ks + 2], sc[8 * ks + 3]);
    pa[ks][2] = pack_f32(sc[8 * ks + 4], sc[8 * ks + 5]);
    pa[ks][3] = pack_f32(sc[8 * ks + 6], sc[8 * ks + 7]);
  }
}

// Columns >= kv_valid (col0 is the tile's first) set to -inf on the last
// tile: the zero rows TMA fills in would otherwise score 0.
__device__ __forceinline__ void mask_tail(float (&sc)[64], int col0,
                                          int kv_valid, int t) {
  if (col0 + kBlockN > kv_valid) {  // the last tile
#pragma unroll
    for (int i = 0; i < 16; ++i) {
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

// Whether the kv tile at col0 hides any (hides_any) or every (hides_all)
// score of the q rows [row0, row0 + 64): row i sees the columns j < s with
// |i - j| <= window, and the walk keeps col0 < s.
__device__ __forceinline__ bool hides_any(int col0, int row0, int s,
                                          int window) {
  return col0 + kBlockN > s || row0 + 63 - col0 > window ||
         col0 + kBlockN - 1 - row0 > window;
}

__device__ __forceinline__ bool hides_all(int col0, int row0, int window) {
  return col0 + kBlockN - 1 < row0 - window || col0 > row0 + 63 + window;
}

// The hidden scores of a thread's rows row_a, row_b (t its index in the
// quad) set to -inf: the visible columns of row i are
// [i - window, min(i + window, s - 1)].
__device__ __forceinline__ void mask_band(float (&sc)[64], int col0,
                                          int row_a, int row_b, int s,
                                          int window, int t) {
  const int lo_a = row_a - window, hi_a = min(row_a + window, s - 1);
  const int lo_b = row_b - window, hi_b = min(row_b + window, s - 1);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = col0 + 8 * i + 2 * t + e;
      if (j < lo_a || j > hi_a) sc[4 * i + e] = -INFINITY;
      if (j < lo_b || j > hi_b) sc[4 * i + 2 + e] = -INFINITY;
    }
  }
}

// One tile of a consumer, after its scores are masked: the softmax, o
// rescaled, o += p v; then the stage released (its empty barrier) once
// wgmma.wait_group shows the p v on it complete.
__device__ __forceinline__ void softmax_pv(float (&sc)[64], float (&o)[32],
                                           RowStats& st, Smem& sm, int s,
                                           int lane) {
  float alpha_a, alpha_b;
  online_softmax(sc, st, alpha_a, alpha_b);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    o[4 * i] *= alpha_a;
    o[4 * i + 1] *= alpha_a;
    o[4 * i + 2] *= alpha_b;
    o[4 * i + 3] *= alpha_b;
  }
  uint32_t pa[8][4];
  pack_p(sc, pa);
  sm90::fence_regs(o);  // the rescale and p land before the fence
  sm90::fence_regs(pa);
  sm90::wgmma_fence();
  issue_pv(o, pa, sm.v[s]);
  sm90::wgmma_wait<0>();
  sm90::fence_regs(o);
  sm90::fence_regs(pa);
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);  // k and v of stage s read
}

// A consumer's store: o * inv_a (its row r_a) and o * inv_b (r_b) in bf16
// into its own q rows sq_c (all its q k^T products are done) in the
// 128-byte swizzled layout the o map stores from, then one TMA store of its
// 64 rows from q0 + 64 c (rows past sq clipped). tid, t, r_a and r_b are
// the consumer thread's index in its warpgroup, in its quad, and its two
// rows in the 64.
__device__ __forceinline__ void store_o(const float (&o)[32], float inv_a,
                                        float inv_b, __nv_bfloat16* sq_c,
                                        const CUtensorMap* tm_o, int c, int bh,
                                        int q0, int sq, int tid, int t,
                                        int r_a, int r_b) {
  // the 16-byte chunk i of row r sits at chunk i ^ (r % 8)
  sm90::named_barrier_sync(1 + c, 128);
  uint8_t* so = reinterpret_cast<uint8_t*>(sq_c);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int off = ((i ^ (r_a & 7)) << 4) + 4 * t;  // r_b % 8 == r_a % 8
    *reinterpret_cast<uint32_t*>(so + r_a * kRowBytes + off) =
        pack_f32(o[4 * i] * inv_a, o[4 * i + 1] * inv_a);
    *reinterpret_cast<uint32_t*>(so + r_b * kRowBytes + off) =
        pack_f32(o[4 * i + 2] * inv_b, o[4 * i + 3] * inv_b);
  }
  sm90::fence_proxy_async();
  sm90::named_barrier_sync(1 + c, 128);
  const int row0 = q0 + c * 64;
  if (tid == 0 && row0 < sq) {
    sm90::tma_store_3d(tm_o, so, 0, row0, bh);
    sm90::tma_store_wait();
  }
}

// A consumer's epilogue: o * (1 / l) stored (store_o), and lse = m +
// log2(l) for rows below sq.
__device__ __forceinline__ void store_o_lse(const float (&o)[32],
                                            const RowStats& st,
                                            __nv_bfloat16* sq_c,
                                            const CUtensorMap* tm_o,
                                            float* __restrict__ lse, int c,
                                            int bh, int q0, int sq, int tid,
                                            int t, int r_a, int r_b) {
  const float l_sum_a = quad_sum(st.l_a), l_sum_b = quad_sum(st.l_b);
  // 1/l, or 1 for a row that saw nothing (its o is 0)
  const float inv_a = l_sum_a <= 0.f ? 1.f : 1.f / l_sum_a;
  const float inv_b = l_sum_b <= 0.f ? 1.f : 1.f / l_sum_b;
  store_o(o, inv_a, inv_b, sq_c, tm_o, c, bh, q0, sq, tid, t, r_a, r_b);
  const int row0 = q0 + c * 64;
  if (t == 0) {
    float* lb = lse + (size_t)bh * sq;
    if (row0 + r_a < sq) lb[row0 + r_a] = st.m_a + log2f(fmaxf(l_sum_a, 1e-30f));
    if (row0 + r_b < sq) lb[row0 + r_b] = st.m_b + log2f(fmaxf(l_sum_b, 1e-30f));
  }
}

// A launch's tensor maps, 3-D (d, rows, b*h) with the 128-byte swizzle: q
// and o over sq rows, in boxes of the block's rows and a consumer's 64; k
// and v over kv_rows rows (rows at or past it, and past the head's skv,
// read as zeros, so no tile reads another head's rows), in boxes of
// kBlockN.
struct Maps {
  CUtensorMap q, k, v, o;
};

inline int encode_maps(Maps& m, const void* q, const void* k, const void* v,
                       void* o, int bh, int sq, int skv, int kv_rows) {
  const uint64_t q_head = (uint64_t)sq * kRowBytes;
  const uint64_t kv_head = (uint64_t)skv * kRowBytes;
  int err = sm90::encode_rows_sw128(&m.q, q, sq, bh, q_head, kBlockM);
  if (!err) err = sm90::encode_rows_sw128(&m.k, k, kv_rows, bh, kv_head, kBlockN);
  if (!err) err = sm90::encode_rows_sw128(&m.v, v, kv_rows, bh, kv_head, kBlockN);
  if (!err) err = sm90::encode_rows_sw128(&m.o, o, sq, bh, q_head, 64);
  return err;
}

}  // namespace fwd90
}  // namespace ea
