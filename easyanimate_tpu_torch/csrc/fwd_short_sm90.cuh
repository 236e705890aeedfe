// The pieces of K1's persistent short-head forward, flash_fwd_short_sm90
// (flash_fwd.cu), for heads of at most 64 q rows and 64 kv rows at head
// dims 144 (V1's and V2's motion modules: V2's temporal pass over 36
// frames, V1's grid over 4 x 16 tokens) and 72 (V3's temporal passes
// over 36 frames): one 64-row wgmma tile holds a whole head, so a head is
// one q k^T, one softmax over one kv tile (no running max) and one p v.
//
// Such a pass is bound by its bytes (V2's [16,384, 36, 144]: 0.68 GB of
// q, k, v and o against 12 GFLOP), and an SM keeps the memory busy only
// with about two heads' loads in flight behind the head it computes
// (3.35 TB/s over 132 SMs, times a load's latency of a microsecond or
// two, is 25-50 KB; a head at 36 rows and d 144 loads 31 KB). The block:
//   - one block an SM (the grid is the SM count, or b*h if fewer); block b
//     walks heads b, b + gridDim.x, ..., so b*h needs no fold;
//   - warp 8 is the producer: one thread loads each head's q, k and v by
//     TMA into the next stage of a ring (full/empty mbarriers); warps 0-3
//     and 4-7 are two consumer warpgroups that take alternate heads (the
//     block's head i goes to consumer i % 2, stage i % kStages);
//   - a row is kLo 64-column boxes of 128-byte swizzle (columns 0-63, and
//     64-127 at d 144) and one 16-column box of 32-byte swizzle (columns
//     128-143 at d 144; 64-79 at d 72, TMA filling 72-79 with zeros); q,
//     k and v take 64 rows each, rows past sq or kv_valid TMA's zeros,
//     the scores of the latter masked by index. A stage is 54 KB at d 144
//     (4 stages: two heads computed, two loading) and 30 KB at d 72 (7).
//     Tried on the card and dropped
//     (NVIDIA H100 80GB HBM3, 700 W, tools/kernel_ab.py): 48-row k and v
//     boxes for heads of at most 48 kv rows, 5 and 8 stages, were within
//     0.7% at 36-row heads;
//   - q k^T is 4 kLo + 1 k16 steps of m64n64k16 into 32 f32 a thread;
//     the base-2 softmax of that one tile in registers; p v, p
//     re-packed to bf16 as the A operand, is m64n64 per lo box and m64n16
//     (d 144) or m64n8 (d 72) over the hi box a k16 step, from v in shared
//     memory read MN-major as K1's blocks read it;
//   - the epilogue writes o * (1 / l) in bf16 over the head's q rows of its
//     stage (the q boxes' swizzled layout) and stores it by TMA, which
//     clips rows >= sq and columns >= D; lse = m + log2(l) by plain
//     stores. The stage goes back to the producer (one arrive) once the
//     store has read it, so the next heads' loads run behind this head's
//     products and store;
//   - no setmaxnreg: 288 threads leave 224 registers a thread, past what
//     a consumer holds (o 72 f32 at d 144, the scores 32, p 16).
#pragma once

#include "fwd_sm90.cuh"
#include "hopper.cuh"

namespace ea {
namespace fwdshort {

// The boxes of a row of D columns: kLo 64-column boxes, then one box of
// the next 16 columns, of which p v writes kHiOut.
template <int D>
struct Row;

template <>
struct Row<72> {
  static constexpr int kLo = 1;
  static constexpr int kHiOut = 8;   // columns 64-71 (72-79 zero)
};

template <>
struct Row<144> {
  static constexpr int kLo = 2;
  static constexpr int kHiOut = 16;  // columns 128-143
};

constexpr int kLoCols = 64;
constexpr int kHiCols = 16;
constexpr int kLoRowBytes = kLoCols * 2;  // 128
constexpr int kHiRowBytes = kHiCols * 2;  // 32
constexpr int kRows = 64;                 // q, k and v rows: one wgmma tile
constexpr int kConsumers = 2;
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kThreads = 128 * kConsumers + 32;
constexpr int kMaxStages = 8;
// the dynamic shared memory a block may take on an H100
constexpr size_t kSmemLimit = 232448;

template <int D>
constexpr int kLo = Row<D>::kLo;
template <int D>
constexpr int kHiOut = Row<D>::kHiOut;

// One head: every lo box first, then the hi boxes, so each lo box starts
// 1024-byte aligned (the 128-byte swizzle's atom) and each hi box 512-byte
// aligned (past the 32-byte swizzle's 256-byte atom); the stage's size is
// a multiple of 1024.
template <int D>
struct Stage {
  __nv_bfloat16 q_lo[kLo<D>][kRows * kLoCols];
  __nv_bfloat16 k_lo[kLo<D>][kRows * kLoCols];
  __nv_bfloat16 v_lo[kLo<D>][kRows * kLoCols];
  __nv_bfloat16 q_hi[kRows * kHiCols];
  __nv_bfloat16 k_hi[kRows * kHiCols];
  __nv_bfloat16 v_hi[kRows * kHiCols];
};

// as many stages as fit beside the barriers and the alignment slack: 4 at
// d 144, 7 at d 72
template <int D>
constexpr int kStages =
    (kSmemLimit - 2048) / sizeof(Stage<D>) < kMaxStages
        ? static_cast<int>((kSmemLimit - 2048) / sizeof(Stage<D>))
        : kMaxStages;

template <int D>
struct Smem {
  Stage<D> st[kStages<D>];
  uint64_t full[kStages<D>];
  uint64_t empty[kStages<D>];
};
template <int D>
constexpr size_t kSmemBytes = sizeof(Smem<D>) + 1024;  // + alignment

static_assert(sizeof(Stage<72>) % 1024 == 0, "stage alignment");
static_assert(kSmemBytes<144> <= kSmemLimit, "d 144 stages");
static_assert(kSmemBytes<72> <= kSmemLimit, "d 72 stages");

// A launch's tensor maps: each tensor's lo map (64-column boxes, placed
// at columns 0 and 64) and hi map (the 16-column box at 64 kLo); q and o
// over sq rows a head, k and v over kv_valid rows (of skv a head), in
// boxes of 64 rows.
struct Maps {
  CUtensorMap q_lo, q_hi, k_lo, k_hi, v_lo, v_hi, o_lo, o_hi;
};

template <int D>
inline int encode_pair(CUtensorMap* lo, CUtensorMap* hi, const void* base,
                       int rows, int head_rows, int bh) {
  const uint64_t head = (uint64_t)head_rows * D * 2;
  int err = sm90::encode_rows(lo, base, D, rows, bh, head, kLoCols, kRows,
                              CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err) err = sm90::encode_rows(hi, base, D, rows, bh, head, kHiCols,
                                    kRows, CU_TENSOR_MAP_SWIZZLE_32B);
  return err;
}

template <int D>
inline int encode_maps(Maps& m, const void* q, const void* k, const void* v,
                       void* o, int bh, int sq, int skv, int kv_valid) {
  int err = encode_pair<D>(&m.q_lo, &m.q_hi, q, sq, sq, bh);
  if (!err) err = encode_pair<D>(&m.k_lo, &m.k_hi, k, kv_valid, skv, bh);
  if (!err) err = encode_pair<D>(&m.v_lo, &m.v_hi, v, kv_valid, skv, bh);
  if (!err) err = encode_pair<D>(&m.o_lo, &m.o_hi, o, sq, sq, bh);
  return err;
}

template <int D>
__device__ __forceinline__ Smem<D>& init_smem() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::smem_u32(smem_raw);
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      smem_raw + (((base + 1023) & ~1023u) - base));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages<D>; ++s) {
      sm90::mbar_init(&sm.full[s], 1);   // the producer's arrive
      sm90::mbar_init(&sm.empty[s], 1);  // the consumer's, after its store
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();
  return sm;
}

// The producer (one thread): n_heads heads, bh0 + i * stride, through the
// ring. A stage's transaction count is its boxes' full bytes, TMA's zero
// fill included.
template <int D>
__device__ __forceinline__ void produce(Smem<D>& sm, const Maps& m,
                                        int bh0, int stride, int n_heads) {
  constexpr int kS = kStages<D>;
  for (int i = 0; i < n_heads; ++i) {
    const int s = i % kS;
    const int bh = bh0 + i * stride;
    Stage<D>& t = sm.st[s];
    // the first pass over the ring finds every stage free
    sm90::mbar_wait(&sm.empty[s], ((i / kS) & 1) ^ 1);
    sm90::mbar_arrive_expect_tx(&sm.full[s], sizeof(Stage<D>));
#pragma unroll
    for (int l = 0; l < kLo<D>; ++l) {
      sm90::tma_load_3d(t.q_lo[l], &m.q_lo, &sm.full[s], kLoCols * l, 0, bh);
      sm90::tma_load_3d(t.k_lo[l], &m.k_lo, &sm.full[s], kLoCols * l, 0, bh);
      sm90::tma_load_3d(t.v_lo[l], &m.v_lo, &sm.full[s], kLoCols * l, 0, bh);
    }
    sm90::tma_load_3d(t.q_hi, &m.q_hi, &sm.full[s], kLoCols * kLo<D>, 0, bh);
    sm90::tma_load_3d(t.k_hi, &m.k_hi, &sm.full[s], kLoCols * kLo<D>, 0, bh);
    sm90::tma_load_3d(t.v_hi, &m.v_hi, &sm.full[s], kLoCols * kLo<D>, 0, bh);
  }
}

// s = q k^T over the head's one kv tile: four k16 steps a lo box, one over
// the hi box (a 32-byte row: one whole k step), committed as one group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], const Stage<D>& t) {
#pragma unroll
  for (int l = 0; l < kLo<D>; ++l) {
    const uint64_t dq = sm90::desc_sw128(t.q_lo[l], 16, 1024);
    const uint64_t dk = sm90::desc_sw128(t.k_lo[l], 16, 1024);
#pragma unroll
    for (int kk = 0; kk < kLoCols / 16; ++kk) {
      sm90::wgmma_m64n64k16_ss(sc, dq + 2 * kk, dk + 2 * kk, l + kk);
    }
  }
  const uint64_t dq = sm90::desc_sw32(t.q_hi, 16, 8 * kHiRowBytes);
  const uint64_t dk = sm90::desc_sw32(t.k_hi, 16, 8 * kHiRowBytes);
  sm90::wgmma_m64n64k16_ss(sc, dq, dk, 1);
  sm90::wgmma_commit();
}

// o = p v: k step ks takes p's columns 16ks..16ks+15 from registers and
// v's rows 16ks..16ks+15 (2048 bytes on in a lo box, 512 in the hi box),
// into one accumulator a lo box and one over the hi box's first kHiOut
// columns; the first step overwrites. Committed as one group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o_lo)[kLo<D>][32],
                                         float (&o_hi)[kHiOut<D> / 2],
                                         const uint32_t (&pa)[kRows / 16][4],
                                         const Stage<D>& t) {
  const uint64_t dv_hi = sm90::desc_sw32(t.v_hi, 8 * kHiRowBytes,
                                         8 * kHiRowBytes);
#pragma unroll
  for (int ks = 0; ks < kRows / 16; ++ks) {
#pragma unroll
    for (int l = 0; l < kLo<D>; ++l) {
      const uint64_t dv = sm90::desc_sw128(t.v_lo[l], 1024, 1024);
      sm90::wgmma_m64n64k16_rs_tb(o_lo[l], pa[ks],
                                  dv + ks * (16 * kLoRowBytes >> 4), ks);
    }
    const uint64_t dh = dv_hi + ks * (16 * kHiRowBytes >> 4);
    if constexpr (kHiOut<D> == 16) {
      sm90::wgmma_m64n16k16_rs_tb(o_hi, pa[ks], dh, ks);
    } else {
      sm90::wgmma_m64n8k16_rs_tb(o_hi, pa[ks], dh, ks);
    }
  }
  sm90::wgmma_commit();
}

// One consumer warpgroup: heads c, c + 2, ... of the block's walk. tid,
// t, r_a and r_b: the thread's index in its warpgroup, in its quad, and
// its two rows of the head.
template <int D>
__device__ __forceinline__ void consume(Smem<D>& sm, const Maps& m,
                                        float* __restrict__ lse, int c,
                                        int bh0, int stride, int n_heads,
                                        int sq, int kv_valid) {
  constexpr int kS = kStages<D>;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_a = warp * 16 + g;
  const int r_b = r_a + 8;
  for (int i = c; i < n_heads; i += kConsumers) {
    const int s = i % kS;
    const int bh = bh0 + i * stride;
    Stage<D>& st = sm.st[s];
    sm90::mbar_wait(&sm.full[s], (i / kS) & 1);
    float sc[kRows / 2];
#pragma unroll
    for (int k = 0; k < kRows / 2; ++k) sc[k] = 0.f;
    sm90::wgmma_fence();
    issue_qk<D>(sc, st);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    // columns >= kv_valid: TMA's zero rows would score 0
#pragma unroll
    for (int i8 = 0; i8 < kRows / 8; ++i8) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * i8 + 2 * t + e >= kv_valid) {
          sc[4 * i8 + e] = -INFINITY;
          sc[4 * i8 + 2 + e] = -INFINITY;
        }
      }
    }
    // the softmax of the head's one tile: column 0 is always visible, so
    // each row's max is finite
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i8 = 0; i8 < kRows / 8; ++i8) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * i8], sc[4 * i8 + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * i8 + 2], sc[4 * i8 + 3]));
    }
    const float m_a = fwd90::quad_max(mx_a);
    const float m_b = fwd90::quad_max(mx_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i8 = 0; i8 < kRows / 8; ++i8) {
      sc[4 * i8] = sm90::fast_exp2(sc[4 * i8] - m_a);
      sc[4 * i8 + 1] = sm90::fast_exp2(sc[4 * i8 + 1] - m_a);
      sc[4 * i8 + 2] = sm90::fast_exp2(sc[4 * i8 + 2] - m_b);
      sc[4 * i8 + 3] = sm90::fast_exp2(sc[4 * i8 + 3] - m_b);
      sum_a += sc[4 * i8] + sc[4 * i8 + 1];
      sum_b += sc[4 * i8 + 2] + sc[4 * i8 + 3];
    }
    uint32_t pa[kRows / 16][4];
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
      pa[ks][0] = pack_f32(sc[8 * ks], sc[8 * ks + 1]);
      pa[ks][1] = pack_f32(sc[8 * ks + 2], sc[8 * ks + 3]);
      pa[ks][2] = pack_f32(sc[8 * ks + 4], sc[8 * ks + 5]);
      pa[ks][3] = pack_f32(sc[8 * ks + 6], sc[8 * ks + 7]);
    }
    sm90::fence_regs(pa);  // p lands before the fence
    float o_lo[kLo<D>][32], o_hi[kHiOut<D> / 2];
#pragma unroll
    for (int l = 0; l < kLo<D>; ++l) {
#pragma unroll
      for (int k = 0; k < 32; ++k) o_lo[l][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < kHiOut<D> / 2; ++k) o_hi[k] = 0.f;
    sm90::wgmma_fence();
    issue_pv<D>(o_lo, o_hi, pa, st);
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int l = 0; l < kLo<D>; ++l) sm90::fence_regs(o_lo[l]);
    sm90::fence_regs(o_hi);
    sm90::fence_regs(pa);

    const float l_a = fwd90::quad_sum(sum_a);
    const float l_b = fwd90::quad_sum(sum_b);
    const float inv_a = 1.f / l_a;  // l >= 1: the max column gives 1
    const float inv_b = 1.f / l_b;
    // every warp's q k^T and p v done before o overwrites the q rows
    sm90::named_barrier_sync(1 + c, 128);
#pragma unroll
    for (int l = 0; l < kLo<D>; ++l) {
      // chunk i of row r sits at chunk i ^ (r % 8); r_b % 8 == r_a % 8
      uint8_t* so = reinterpret_cast<uint8_t*>(st.q_lo[l]);
#pragma unroll
      for (int i8 = 0; i8 < 8; ++i8) {
        const int off = ((i8 ^ (r_a & 7)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(so + r_a * kLoRowBytes + off) =
            pack_f32(o_lo[l][4 * i8] * inv_a, o_lo[l][4 * i8 + 1] * inv_a);
        *reinterpret_cast<uint32_t*>(so + r_b * kLoRowBytes + off) =
            pack_f32(o_lo[l][4 * i8 + 2] * inv_b,
                     o_lo[l][4 * i8 + 3] * inv_b);
      }
    }
    // the hi box: chunk i of a 32-byte row r at i ^ ((r / 4) % 2), the
    // same for r_a and r_b (8 rows apart)
    uint8_t* sh = reinterpret_cast<uint8_t*>(st.q_hi);
#pragma unroll
    for (int i8 = 0; i8 < kHiOut<D> / 8; ++i8) {
      const int off = ((i8 ^ ((r_a >> 2) & 1)) << 4) + 4 * t;
      *reinterpret_cast<uint32_t*>(sh + r_a * kHiRowBytes + off) =
          pack_f32(o_hi[4 * i8] * inv_a, o_hi[4 * i8 + 1] * inv_a);
      *reinterpret_cast<uint32_t*>(sh + r_b * kHiRowBytes + off) =
          pack_f32(o_hi[4 * i8 + 2] * inv_b, o_hi[4 * i8 + 3] * inv_b);
    }
    sm90::fence_proxy_async();
    sm90::named_barrier_sync(1 + c, 128);
    if (tid == 0) {
#pragma unroll
      for (int l = 0; l < kLo<D>; ++l) {
        sm90::tma_store_3d(&m.o_lo, st.q_lo[l], kLoCols * l, 0, bh);
      }
      sm90::tma_store_3d(&m.o_hi, st.q_hi, kLoCols * kLo<D>, 0, bh);
      sm90::tma_store_wait();
      sm90::mbar_arrive(&sm.empty[s]);  // the stage's q, k, v and o read
    }
    if (t == 0) {
      float* lb = lse + (size_t)bh * sq;
      if (r_a < sq) lb[r_a] = m_a + log2f(l_a);
      if (r_b < sq) lb[r_b] = m_b + log2f(l_b);
    }
  }
}

}  // namespace fwdshort
}  // namespace ea
