// The pieces of the TMA + wgmma attention backward at head_dim 64
// (flash_bwd.cu's note gives the design) that its kernels share:
//   - bwd90: the warpgroup split and its register balance, the two score
//     products, the accumulating product, the epilogue's staging, and the
//     band's tile tests and edge mask (|i - j| <= W is symmetric, and a dq
//     accumulator has the layout of the dk/dv kernels' transposed scores,
//     so one set serves K6's q rows x kv columns and K7's kv rows x q
//     columns);
//   - bwd90::dq: the dq block of 128 q rows, its shared memory, the
//     producer's loads (q and do once, then k/v tiles from any first row),
//     the row stats, the score step, the ds step, the dq product and the dq
//     store. K3 (flash_bwd.cu, dense: kv rows from 0) and K6 (swa_bwd.cu,
//     banded: kv rows from q0 - W) run them; K3 keeps its own copy of the
//     prologue and the producer (flash_bwd.cu says why);
//   - bwd90::dkv: the dk/dv block of 128 kv rows, its shared memory, the
//     producer's loads (k and v once, then q/do tiles from any first row),
//     the row-stats warp, the p^T/ds^T step and the dk/dv stores. K4
//     (flash_bwd.cu, dense: q rows from 0) and K7 (swa_bwd.cu, banded: q
//     rows from k0 - W) run them.
// Each kernel keeps its own consumer loop: what differs is which rows a
// block walks and which scores it hides, and one consumer loop templated on
// the walk grew K1's spills in the forward (fwd_sm90.cuh).
#pragma once

#include "attn_bwd.cuh"
#include "hopper.cuh"

namespace ea {
namespace bwd90 {

constexpr int kD = 64;                      // head_dim of the kernels
constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kBlockThreads = 128 * (kConsumers + 1);
// registers a thread: the launch gives 65536 / 384 = 168 (rounded down to
// 8); the producer's 128 x (168 - 24) given back are the consumers'
// 256 x (240 - 168)
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kRowBytes = kD * 2;           // one bf16 row: 128 bytes

// acc = A B^T over d: A the consumer's 64 rows (descriptor desc_a), B a
// tile's 64 rows, both K-major in shared memory; 4 k steps of 16 over d
// (32 bytes along the 128-byte rows). K3's s = q k^T, dp = do v^T; the
// dk/dv kernels' s^T = k q^T, dp^T = v do^T.
__device__ __forceinline__ void issue_scores(float (&acc)[32], uint64_t desc_a,
                                             const __nv_bfloat16* b_tile) {
  const uint64_t desc_b = sm90::desc_sw128(b_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    sm90::wgmma_m64n64k16_ss(acc, desc_a + 2 * kk, desc_b + 2 * kk, kk);
  }
}

// acc += A B over KS * 16 rows of a tile: A from registers (p, ds, p^T or
// ds^T), B the tile's rows read MN-major; k step ks takes rows
// 16ks..16ks+15 (2048 bytes further on).
template <int KS>
__device__ __forceinline__ void issue_accumulate(
    float (&acc)[32], const uint32_t (&a)[KS][4],
    const __nv_bfloat16* b_tile) {
  const uint64_t desc_b = sm90::desc_sw128(b_tile, 1024, 1024);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    sm90::wgmma_m64n64k16_rs_tb(acc, a[ks],
                                desc_b + ks * (16 * kRowBytes >> 4), 1);
  }
}

// Rows r_a and r_b (= r_a + 8) of a 64 x 64 f32 accumulator, times
// `scale`, as bf16 into 64 rows of shared memory in the 128-byte swizzled
// layout a tensor map stores from (16-byte chunk i of row r at chunk
// i ^ (r % 8)); a row whose keep flag is false is written as zeros.
__device__ __forceinline__ void stage_rows(uint8_t* dst, const float (&acc)[32],
                                           int r_a, bool keep_a, bool keep_b,
                                           float scale, int t) {
  const int r_b = r_a + 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int off = ((i ^ (r_a & 7)) << 4) + 4 * t;  // r_b % 8 == r_a % 8
    *reinterpret_cast<uint32_t*>(dst + r_a * kRowBytes + off) =
        keep_a ? pack_f32(acc[4 * i] * scale, acc[4 * i + 1] * scale) : 0u;
    *reinterpret_cast<uint32_t*>(dst + r_b * kRowBytes + off) =
        keep_b ? pack_f32(acc[4 * i + 2] * scale, acc[4 * i + 3] * scale) : 0u;
  }
}

// Whether the 64-column tile at col0 hides any (hides_any) or every
// (hides_all) pair with the 64 rows [row0, row0 + 64) in the band
// |i - j| <= window: the tests are uniform across a consumer warpgroup.
// K6 passes a kv tile against its q rows, K7 a q tile against its kv rows.
__device__ __forceinline__ bool hides_any(int col0, int row0, int window) {
  return row0 + 63 - col0 > window || col0 + 63 - row0 > window;
}

__device__ __forceinline__ bool hides_all(int col0, int row0, int window) {
  return col0 + 63 < row0 - window || col0 > row0 + 63 + window;
}

// The hidden scores of a thread's rows row_a and row_a + 8 (t its index in
// the quad) set to -inf before the exponential: element 4i + e of the
// 64 x 64 accumulator holds column col0 + 8i + 2t + (e & 1), of row_a for
// e < 2 and of row_a + 8 after.
__device__ __forceinline__ void mask_band(float (&acc)[32], int col0,
                                          int row_a, int window, int t) {
  // the visible columns of row_a, counted from the tile's first
  const int lo = row_a - window - col0, hi = row_a + window - col0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * i + 2 * t + e;
      if (c < lo || c > hi) acc[4 * i + e] = -INFINITY;
      if (c < lo + 8 || c > hi + 8) acc[4 * i + 2 + e] = -INFINITY;
    }
  }
}

namespace dq {

constexpr int kBlockM = 64 * kConsumers;    // q rows per block
constexpr int kBlockN = 64;                 // kv rows per stage
constexpr int kStages = 4;
constexpr uint32_t kQBytes = kBlockM * kRowBytes;
constexpr uint32_t kTileBytes = kBlockN * kRowBytes;

// Every tile starts 1024-byte aligned (the 128-byte swizzle's atom).
struct Smem {
  __nv_bfloat16 q[kBlockM * kD];
  __nv_bfloat16 dout[kBlockM * kD];
  __nv_bfloat16 k[kStages][kBlockN * kD];
  __nv_bfloat16 v[kStages][kBlockN * kD];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

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

// The producer warpgroup: its first thread loads the block's q and do rows
// [q0, q0 + kBlockM) once, then n_tiles k and v tiles of kBlockN rows from
// kv row kv_begin on (any row: a TMA box need not start aligned) through
// the ring. The consumers count the same tiles, as the mbarrier parities
// need.
__device__ __forceinline__ void produce(Smem& sm, const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_do,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v, int bh,
                                        int q0, int kv_begin, int n_tiles) {
  sm90::setmaxnreg_dec<kProducerRegs>();
  if (threadIdx.x == 0) {
    sm90::mbar_arrive_expect_tx(&sm.q_full, 2 * kQBytes);
    sm90::tma_load_3d(sm.q, tm_q, &sm.q_full, 0, q0, bh);
    sm90::tma_load_3d(sm.dout, tm_do, &sm.q_full, 0, q0, bh);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      // the first pass over the ring finds every stage free
      sm90::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes);
      const int row = kv_begin + j * kBlockN;
      sm90::tma_load_3d(sm.k[s], tm_k, &sm.full[s], 0, row, bh);
      sm90::tma_load_3d(sm.v[s], tm_v, &sm.full[s], 0, row, bh);
    }
  }
}

// lse and di of a consumer thread's two q rows, loaded once: +inf and 0
// past sq, so p = 0 and ds = 0 there. Their head stride, 4 * sq bytes,
// never meets TMA.
struct RowStats {
  float lse_a, lse_b, di_a, di_b;
};

__device__ __forceinline__ RowStats row_stats(const float* __restrict__ lse,
                                              const float* __restrict__ di,
                                              int bh, int sq, int i_a) {
  const float* lb = lse + (size_t)bh * sq;
  const float* db = di + (size_t)bh * sq;
  const int i_b = i_a + 8;
  return {i_a < sq ? lb[i_a] : INFINITY, i_b < sq ? lb[i_b] : INFINITY,
          i_a < sq ? db[i_a] : 0.f, i_b < sq ? db[i_b] : 0.f};
}

// s = q k^T and dp = do v^T for the kv tile of stage s: the consumer's 64 q
// rows (descriptors desc_q, desc_do) against the tile's 64 kv rows.
__device__ __forceinline__ void tile_scores(float (&sc)[kBlockN / 2],
                                            float (&dp)[kBlockN / 2],
                                            uint64_t desc_q, uint64_t desc_do,
                                            Smem& sm, int s) {
  sm90::wgmma_fence();
  issue_scores(sc, desc_q, sm.k[s]);   // s = q k^T
  issue_scores(dp, desc_do, sm.v[s]);  // dp = do v^T
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(sc);
  sm90::fence_regs(dp);
}

// ds = p (dp - di) with p = exp2(s - lse) for one kv tile (col0 its first
// column, any row), in place in sc, packed to bf16 as the A fragments of
// ds k (the scores of two adjacent 8-column chunks form k step ks). On the
// tile that crosses kv_valid the columns >= kv_valid get s = -inf first, so
// p = 0 there: their zero k rows score 0, and 2^(-lse) overflows once
// lse < -128.
__device__ __forceinline__ void ds_tile(float (&sc)[kBlockN / 2],
                                        const float (&dp)[kBlockN / 2],
                                        const RowStats& st, int col0,
                                        int kv_valid, int t,
                                        uint32_t (&da)[kBlockN / 16][4]) {
  if (col0 + kBlockN > kv_valid) {  // the tile that crosses kv_valid
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
#pragma unroll
  for (int i = 0; i < kBlockN / 8; ++i) {
    sc[4 * i] = sm90::fast_exp2(sc[4 * i] - st.lse_a) * (dp[4 * i] - st.di_a);
    sc[4 * i + 1] = sm90::fast_exp2(sc[4 * i + 1] - st.lse_a) * (dp[4 * i + 1] - st.di_a);
    sc[4 * i + 2] = sm90::fast_exp2(sc[4 * i + 2] - st.lse_b) * (dp[4 * i + 2] - st.di_b);
    sc[4 * i + 3] = sm90::fast_exp2(sc[4 * i + 3] - st.lse_b) * (dp[4 * i + 3] - st.di_b);
  }
#pragma unroll
  for (int ks = 0; ks < kBlockN / 16; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      da[ks][r] = pack_f32(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
    }
  }
}

// Stage s's k/v tile read by this warp: one arrive on its empty barrier.
__device__ __forceinline__ void release(Smem& sm, int s, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);
}

// dq += ds k (RS wgmma, k read MN-major from stage s: K1's p v), then the
// stage released once wgmma.wait_group shows the product complete.
__device__ __forceinline__ void tile_accumulate(float (&dq)[32],
                                                uint32_t (&da)[kBlockN / 16][4],
                                                Smem& sm, int s, int lane) {
  sm90::fence_regs(dq);  // ds lands before the fence
  sm90::fence_regs(da);
  sm90::wgmma_fence();
  issue_accumulate(dq, da, sm.k[s]);  // dq += ds k
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dq);
  sm90::fence_regs(da);
  release(sm, s, lane);  // k and v of stage s read
}

// The epilogue of consumer c (q rows [row0, row0 + 64), all its products
// done): dq * ln2 as bf16 into its own q rows of shared memory, then one
// TMA store, which clips rows past sq.
__device__ __forceinline__ void store_dq(Smem& sm, const CUtensorMap* tm_dq,
                                         const float (&dq)[32], int c, int bh,
                                         int row0, int sq) {
  const int tid = threadIdx.x % 128;
  const int r_a = (tid / 32) * 16 + (tid % 32) / 4;
  const int t = tid % 4;
  sm90::named_barrier_sync(1 + c, 128);
  uint8_t* sdq = reinterpret_cast<uint8_t*>(sm.q + c * 64 * kD);
  stage_rows(sdq, dq, r_a, true, true, kLn2, t);
  sm90::fence_proxy_async();
  sm90::named_barrier_sync(1 + c, 128);
  if (tid == 0 && row0 < sq) {
    sm90::tma_store_3d(tm_dq, sdq, 0, row0, bh);
    sm90::tma_store_wait();
  }
}

// The five tensor maps of a dq launch: q, do and dq [bh, sq, 64] (q and do
// in kBlockM-row boxes, dq in 64-row ones), k and v [bh, skv, 64] in
// kBlockN-row boxes with kv_rows as their extent (rows past it arrive as
// zeros).
struct Maps {
  CUtensorMap q, dout, k, v, dq;
};

inline int encode_maps(Maps& m, const void* q, const void* dout,
                       const void* k, const void* v, void* dq, int bh, int sq,
                       int skv, int kv_rows) {
  const uint64_t q_head = (uint64_t)sq * kRowBytes;
  const uint64_t kv_head = (uint64_t)skv * kRowBytes;
  int err = sm90::encode_rows_sw128(&m.q, q, sq, bh, q_head, kBlockM);
  if (!err) err = sm90::encode_rows_sw128(&m.dout, dout, sq, bh, q_head, kBlockM);
  if (!err) err = sm90::encode_rows_sw128(&m.k, k, kv_rows, bh, kv_head, kBlockN);
  if (!err) err = sm90::encode_rows_sw128(&m.v, v, kv_rows, bh, kv_head, kBlockN);
  if (!err) err = sm90::encode_rows_sw128(&m.dq, dq, sq, bh, q_head, 64);
  return err;
}

}  // namespace dq

namespace dkv {

constexpr int kBlockN = 64 * kConsumers;    // kv rows per block
constexpr int kBlockM = 64;                 // q rows per stage
constexpr int kStages = 3;
constexpr uint32_t kKVBytes = kBlockN * kRowBytes;
constexpr uint32_t kTileBytes = kBlockM * kRowBytes;
constexpr int kStatLanes = 32;              // the warp that copies lse, di

// Every tile starts 1024-byte aligned (the 128-byte swizzle's atom).
struct Smem {
  __nv_bfloat16 k[kBlockN * kD];
  __nv_bfloat16 v[kBlockN * kD];
  __nv_bfloat16 q[kStages][kBlockM * kD];
  __nv_bfloat16 dout[kStages][kBlockM * kD];
  float lse[kStages][kBlockM];
  float di[kStages][kBlockM];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t kv_full;
};
constexpr size_t kSmemBytes = sizeof(Smem) + 1024;  // + alignment slack

// The block's shared memory, 1024-byte aligned, with its barriers
// initialised (one thread, then the whole block synchronised).
__device__ __forceinline__ Smem& init_smem() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::smem_u32(smem_raw);
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + (((base + 1023) & ~1023u) - base));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrive + the row-stats warp's 32
      sm90::mbar_init(&sm.full[s], 1 + kStatLanes);
      sm90::mbar_init(&sm.empty[s], kConsumers * 4);  // one per consumer warp
    }
    sm90::mbar_init(&sm.kv_full, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

// The producer's second warp: lse and di of every q tile into the stages
// (+inf and 0 for rows past sq, so their p is 0). The next tile's values
// are loaded before the wait for its stage, which hides their latency.
__device__ __forceinline__ void copy_row_stats(Smem& sm, const float* lb,
                                               const float* db, int sq,
                                               int q_begin, int n_tiles) {
  const int lane = threadIdx.x % 32;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    float l[kBlockM / kStatLanes], d[kBlockM / kStatLanes];
#pragma unroll
    for (int r = 0; r < kBlockM / kStatLanes; ++r) {
      const int i = q_begin + j * kBlockM + r * kStatLanes + lane;
      l[r] = i < sq ? lb[i] : INFINITY;
      d[r] = i < sq ? db[i] : 0.f;
    }
    sm90::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
#pragma unroll
    for (int r = 0; r < kBlockM / kStatLanes; ++r) {
      sm.lse[s][r * kStatLanes + lane] = l[r];
      sm.di[s][r * kStatLanes + lane] = d[r];
    }
    sm90::mbar_arrive(&sm.full[s]);
  }
}

// The producer warpgroup: its first thread loads the block's k and v rows
// [k0, k0 + kBlockN) once, then n_tiles q and do tiles of kBlockM rows from
// q row q_begin on (any row: a TMA box need not start aligned) through the
// ring; its second warp copies the same tiles' lse and di. The consumers
// count the same tiles, as the mbarrier parities need. With n_tiles 0 it
// loads nothing.
__device__ __forceinline__ void produce(Smem& sm, const CUtensorMap* tm_q,
                                        const CUtensorMap* tm_do,
                                        const CUtensorMap* tm_k,
                                        const CUtensorMap* tm_v,
                                        const float* lse, const float* di,
                                        int bh, int sq, int k0, int q_begin,
                                        int n_tiles) {
  sm90::setmaxnreg_dec<kProducerRegs>();
  if (threadIdx.x == 0 && n_tiles > 0) {
    sm90::mbar_arrive_expect_tx(&sm.kv_full, 2 * kKVBytes);
    sm90::tma_load_3d(sm.k, tm_k, &sm.kv_full, 0, k0, bh);
    sm90::tma_load_3d(sm.v, tm_v, &sm.kv_full, 0, k0, bh);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      // the first pass over the ring finds every stage free
      sm90::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
      sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes);
      const int row = q_begin + j * kBlockM;
      sm90::tma_load_3d(sm.q[s], tm_q, &sm.full[s], 0, row, bh);
      sm90::tma_load_3d(sm.dout[s], tm_do, &sm.full[s], 0, row, bh);
    }
  } else if (threadIdx.x / 32 == 1) {
    copy_row_stats(sm, lse + (size_t)bh * sq, di + (size_t)bh * sq, sq,
                   q_begin, n_tiles);
  }
}

// s^T = k q^T and dp^T = v do^T for the q tile of stage s: the consumer's
// 64 kv rows (descriptors desc_k, desc_v) against the tile's 64 q rows.
__device__ __forceinline__ void tile_scores(float (&st)[kBlockM / 2],
                                            float (&dp)[kBlockM / 2],
                                            uint64_t desc_k, uint64_t desc_v,
                                            Smem& sm, int s) {
  sm90::wgmma_fence();
  issue_scores(st, desc_k, sm.q[s]);     // s^T = k q^T
  issue_scores(dp, desc_v, sm.dout[s]);  // dp^T = v do^T
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(st);
  sm90::fence_regs(dp);
}

// p^T = exp2(s^T - lse[col]) and ds^T = p^T (dp^T - di[col]), packed to
// bf16 as the A fragments of the two accumulating products. Column
// 8i + 2t + (e & 1) of the transposed scores is q row 8i + 2t + (e & 1) of
// the tile.
__device__ __forceinline__ void p_and_ds(float (&st)[kBlockM / 2],
                                         float (&dp)[kBlockM / 2],
                                         const float* lse, const float* di,
                                         int t, uint32_t (&pa)[kBlockM / 16][4],
                                         uint32_t (&da)[kBlockM / 16][4]) {
#pragma unroll
  for (int i = 0; i < kBlockM / 8; ++i) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * i + 2 * t);
    const float2 d = *reinterpret_cast<const float2*>(di + 8 * i + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = sm90::fast_exp2(st[4 * i + e] - ((e & 1) ? l.y : l.x));
      st[4 * i + e] = p;
      dp[4 * i + e] = p * (dp[4 * i + e] - ((e & 1) ? d.y : d.x));
    }
  }
#pragma unroll
  for (int ks = 0; ks < kBlockM / 16; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pa[ks][r] = pack_f32(st[8 * ks + 2 * r], st[8 * ks + 2 * r + 1]);
      da[ks][r] = pack_f32(dp[8 * ks + 2 * r], dp[8 * ks + 2 * r + 1]);
    }
  }
}

// Stage s's q/do tile read by this warp: one arrive on its empty barrier.
__device__ __forceinline__ void release(Smem& sm, int s, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);
}

// From the tile's scores to the sums: p^T, ds^T, then dv += p^T do and
// dk += ds^T q (RS wgmma, do and q read MN-major), and the stage released.
__device__ __forceinline__ void tile_accumulate(float (&dk)[32],
                                                float (&dv)[32],
                                                float (&st)[kBlockM / 2],
                                                float (&dp)[kBlockM / 2],
                                                Smem& sm, int s, int t,
                                                int lane) {
  uint32_t pa[kBlockM / 16][4], da[kBlockM / 16][4];
  p_and_ds(st, dp, sm.lse[s], sm.di[s], t, pa, da);
  sm90::fence_regs(dk);  // p^T and ds^T land before the fence
  sm90::fence_regs(dv);
  sm90::fence_regs(pa);
  sm90::fence_regs(da);
  sm90::wgmma_fence();
  issue_accumulate(dv, pa, sm.dout[s]);  // dv += p^T do
  issue_accumulate(dk, da, sm.q[s]);     // dk += ds^T q
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(dk);
  sm90::fence_regs(dv);
  sm90::fence_regs(pa);
  sm90::fence_regs(da);
  release(sm, s, lane);  // q, do of stage s read
}

// The epilogue of consumer c (kv rows [row0, row0 + 64), all its products
// done): dk * ln2 and dv as bf16 into its own k and v rows of shared
// memory, rows >= kv_valid as zeros (their zero k, v rows score p^T =
// 2^(-lse), not 0), then one TMA store each, which clips rows past skv.
__device__ __forceinline__ void store_dk_dv(Smem& sm, const CUtensorMap* tm_dk,
                                            const CUtensorMap* tm_dv,
                                            const float (&dk)[32],
                                            const float (&dv)[32], int c,
                                            int bh, int row0, int kv_valid,
                                            int skv) {
  const int tid = threadIdx.x % 128;
  const int r_a = (tid / 32) * 16 + (tid % 32) / 4;
  const int t = tid % 4;
  const bool keep_a = row0 + r_a < kv_valid, keep_b = row0 + r_a + 8 < kv_valid;
  sm90::named_barrier_sync(1 + c, 128);
  uint8_t* sdk = reinterpret_cast<uint8_t*>(sm.k + c * 64 * kD);
  uint8_t* sdv = reinterpret_cast<uint8_t*>(sm.v + c * 64 * kD);
  stage_rows(sdk, dk, r_a, keep_a, keep_b, kLn2, t);
  stage_rows(sdv, dv, r_a, keep_a, keep_b, 1.f, t);
  sm90::fence_proxy_async();
  sm90::named_barrier_sync(1 + c, 128);
  if (tid == 0 && row0 < skv) {
    sm90::tma_store_3d(tm_dk, sdk, 0, row0, bh);
    sm90::tma_store_3d(tm_dv, sdv, 0, row0, bh);
    sm90::tma_store_wait();
  }
}

// The six tensor maps of a dk/dv launch: q and do [bh, sq, 64] in kBlockM-
// row boxes, k and v [bh, kv_rows, 64] in kBlockN-row boxes (rows past
// kv_rows arrive as zeros), dk and dv [bh, skv, 64] in 64-row boxes.
struct Maps {
  CUtensorMap q, dout, k, v, dk, dv;
};

inline int encode_maps(Maps& m, const void* q, const void* dout,
                       const void* k, const void* v, void* dk, void* dv,
                       int bh, int sq, int skv, int kv_rows) {
  const uint64_t q_head = (uint64_t)sq * kRowBytes;
  const uint64_t kv_head = (uint64_t)skv * kRowBytes;
  int err = sm90::encode_rows_sw128(&m.q, q, sq, bh, q_head, kBlockM);
  if (!err) err = sm90::encode_rows_sw128(&m.dout, dout, sq, bh, q_head, kBlockM);
  if (!err) err = sm90::encode_rows_sw128(&m.k, k, kv_rows, bh, kv_head, kBlockN);
  if (!err) err = sm90::encode_rows_sw128(&m.v, v, kv_rows, bh, kv_head, kBlockN);
  if (!err) err = sm90::encode_rows_sw128(&m.dk, dk, skv, bh, kv_head, 64);
  if (!err) err = sm90::encode_rows_sw128(&m.dv, dv, skv, bh, kv_head, 64);
  return err;
}

}  // namespace dkv
}  // namespace bwd90
}  // namespace ea
