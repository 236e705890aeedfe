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
// Head dims 16 and 32 (the tiny test preset only) stay on the mma.sync
// body of attn_fwd.cuh: a dispatch by shape in ea_flash_fwd_bf16, never a
// fallback on failure. ea_flash_fwd_uses_sm90 tells the wrapper which ran.
#include "attn_fwd.cuh"
#include "hopper.cuh"

namespace ea {
namespace k1 {

constexpr int kD = 64;                       // head_dim of this kernel
constexpr int kConsumers = 3;                // consumer warpgroups
constexpr int kBlockM = 64 * kConsumers;     // q rows per block
constexpr int kBlockN = 128;                 // kv rows per stage
constexpr int kStages = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
// registers a thread: the launch gives 65536 / 512 = 128; the producer's
// 128 x (128 - 32) given back are the consumers' 384 x (160 - 128)
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

// The online base-2 softmax of one tile's scores, in place: columns
// >= kv_valid (col0 is the tile's first) set to -inf, the row maxima folded
// into st.m, the scores turned into p = exp2(s - m) and summed into st.l.
// Returns in alpha_* the factors o must be scaled by before this tile's p v.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], RowStats& st,
                                             int col0, int kv_valid, int t,
                                             float& alpha_a, float& alpha_b) {
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
  RowStats st{-INFINITY, -INFINITY, 0.f, 0.f};

  sm90::mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    sm90::mbar_wait(&sm.full[s], (j / kStages) & 1);
    float sc[64], alpha_a, alpha_b;
    sm90::wgmma_fence();
    issue_qk(sc, desc_q, sm.k[s]);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(sc);
    softmax_tile(sc, st, j * kBlockN, kv_valid, t, alpha_a, alpha_b);
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
  const float l_sum_a = quad_sum(st.l_a), l_sum_b = quad_sum(st.l_b);
  // 1/l, or 1 for a row that saw nothing (its o is 0)
  const float inv_a = l_sum_a <= 0.f ? 1.f : 1.f / l_sum_a;
  const float inv_b = l_sum_b <= 0.f ? 1.f : 1.f / l_sum_b;

  // o into this consumer's q rows (all its q k^T products are done), in the
  // 128-byte swizzled layout the o map stores from: the 16-byte chunk i of
  // row r sits at chunk i ^ (r % 8)
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
  if (t == 0) {
    float* lb = lse + (size_t)bh * sq;
    if (row0 + r_a < sq) lb[row0 + r_a] = st.m_a + log2f(fmaxf(l_sum_a, 1e-30f));
    if (row0 + r_b < sq) lb[row0 + r_b] = st.m_b + log2f(fmaxf(l_sum_b, 1e-30f));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               const __grid_constant__ CUtensorMap tm_o,
               float* __restrict__ lse, int sq, int kv_valid) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::smem_u32(smem_raw);
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + (((base + 1023) & ~1023u) - base));

  const int warpgroup = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockM;
  const int n_tiles = (kv_valid + kBlockN - 1) / kBlockN;

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

  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(&sm.q_full, kQBytes);
      sm90::tma_load_3d(sm.q, &tm_q, &sm.q_full, 0, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        // the first pass over the ring finds every stage free
        sm90::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes);
        sm90::tma_load_3d(sm.k[s], &tm_k, &sm.full[s], 0, j * kBlockN, bh);
        sm90::tma_load_3d(sm.v[s], &tm_v, &sm.full[s], 0, j * kBlockN, bh);
      }
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume(sm, &tm_o, lse, warpgroup - 1, bh, q0, sq, kv_valid, n_tiles);
  }
}

int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int sq, int skv, int kv_valid, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  const uint64_t q_head = (uint64_t)sq * kRowBytes;
  const uint64_t kv_head = (uint64_t)skv * kRowBytes;
  int err = sm90::encode_rows_sw128(&tm_q, q, sq, bh, q_head, kBlockM);
  if (!err) err = sm90::encode_rows_sw128(&tm_k, k, kv_valid, bh, kv_head, kBlockN);
  if (!err) err = sm90::encode_rows_sw128(&tm_v, v, kv_valid, bh, kv_head, kBlockN);
  if (!err) err = sm90::encode_rows_sw128(&tm_o, o, sq, bh, q_head, 64);
  if (err) return err;
  cudaError_t st = cudaFuncSetAttribute(
      flash_fwd_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (st != cudaSuccess) return static_cast<int>(st);
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_fwd_sm90<<<grid, kThreads, kSmemBytes, stream>>>(
      tm_q, tm_k, tm_v, tm_o, static_cast<float*>(lse), sq, kv_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k1
}  // namespace ea

extern "C" int ea_flash_fwd_uses_sm90(int head_dim) {
  return head_dim == ea::k1::kD;
}

extern "C" int ea_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int sq, int skv,
                                 int kv_valid, int head_dim, void* stream) {
  if (ea_flash_fwd_uses_sm90(head_dim)) {
    return ea::k1::launch(q, k, v, o, lse, bh, sq, skv, kv_valid,
                          reinterpret_cast<cudaStream_t>(stream));
  }
  return ea::launch_attn_fwd<false>(q, k, v, o, lse, bh, sq, skv, kv_valid,
                                    /*window=*/0, head_dim, stream);
}
