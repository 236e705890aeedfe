// K3 and K4: dense flash-attention backward for the MMDiT joint text+video
// attention and the SWA cross pass (the training step's gradient of K1).
//
// Replaces the TPU kernels easyanimate_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (K3) and ::_bwd_dkv_kernel (K4), driven by _flash_bwd. The
// TPU kernels carry the dq / dk, dv sums in VMEM scratch across their
// sequential grid axis and rely on zero-padded k and v: there the pad
// columns get p = 2^(-lse), not 0, and the wrapper slices the pad rows'
// dk/dv away. Here a CUDA block loops over the tiles itself, and the pad
// rows are masked by index, so the dk/dv rows in [kv_valid, skv) come out
// exactly 0 and no padded copies exist.
//
// Bound on the H100: at the dense flagship shape (b*h = 96, S = 13,360,
// d = 64) K3 runs 3 products of 2*S^2*d per head and K4 runs 4 (8.8 TFLOP,
// 8.871 ms at 989 TFLOP/s) against ~0.1 GB of q/k/v/do/dk/dv traffic each:
// both are bound by operations.
//
// K3 (dq, every head dim) and K4 at head dims 16 and 32 (the tiny test
// preset only) run the mma.sync bodies of attn_bwd.cuh. K4 at d 64 is
// flash_bwd_dkv_sm90 below, on hopper.cuh's TMA + wgmma pieces:
//   - one block of 3 warpgroups per (128 kv rows, b*h): warpgroup 0 is the
//     producer (24 registers), warpgroups 1-2 are consumers (240), each
//     owning 64 of the kv rows. Its k and v rows arrive once by TMA and stay
//     in shared memory as the A operands of the two score products; its
//     dk and dv sums (64 x 64 f32 each) stay in registers for the whole
//     q loop, so every dk/dv row has one writer and no atomics;
//   - the producer's elected thread streams q and do tiles of kBlockM rows
//     by TMA through a ring of kStages stages (full/empty mbarriers); rows
//     past Sq arrive as zeros. lse and di cannot come by TMA (their head
//     stride, 4 * Sq bytes, need not be a multiple of 16), so the
//     producer's second warp copies each stage's slice into shared memory
//     with plain loads (lse = +inf for rows past Sq, so p = 0 there) and
//     arrives on the stage's full barrier too;
//   - per q tile a consumer computes the TRANSPOSED scores s^T = k q^T and
//     dp^T = v do^T (wgmma, both operands K-major in shared memory), then
//     in registers p^T = exp2(s^T - lse[col]) and ds^T = p^T (dp^T -
//     di[col]), packs both to bf16 A fragments (the accumulator layout is
//     the A layout) and accumulates dv += p^T do and dk += ds^T q (wgmma
//     with A from registers and do, q read MN-major from the same stage).
//     It releases the stage only after wgmma.wait_group shows both of
//     those products complete;
//   - kv rows at or past kv_valid arrive as zero k and v rows, whose p^T
//     is 2^(-lse), not 0. A row of dv (dk) depends only on the same row of
//     p^T (ds^T), so the epilogue writes those rows as exact zeros instead
//     of masking every tile; blocks wholly past kv_valid skip the q loop;
//   - epilogue: dk * ln2 and dv in bf16 go into the consumer's finished k
//     and v rows of shared memory (128-byte swizzle) and out by one TMA
//     store each, which clips rows past skv.
// Per 64-row q tile a block runs 4 products of 2 * 128 * 64 * 64 (~1,024
// tensor-core cycles at the peak) against 8,192 exponentials (~512 cycles
// on the MUFU units): the products lead, and the two consumers fill each
// other's elementwise gaps. Tried on the card and dropped (PERF.md):
// 128-row q tiles and 3 consumers (192 kv rows at 160 registers) both
// spill; issuing the next tile's score products ahead of this tile's
// accumulating ones spilled at 240 registers. Two and three stages time
// alike.
#include "attn_bwd.cuh"
#include "hopper.cuh"

namespace ea {
namespace k4 {

constexpr int kD = 64;                      // head_dim of this kernel
constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kBlockN = 64 * kConsumers;    // kv rows per block
constexpr int kBlockM = 64;                 // q rows per stage
constexpr int kStages = 3;
constexpr int kThreads = 128 * (kConsumers + 1);
// registers a thread: the launch gives 65536 / 384 = 168 (rounded down to
// 8); the producer's 128 x (168 - 24) given back are the consumers'
// 256 x (240 - 168)
constexpr int kLaunchRegs = 168;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kRowBytes = kD * 2;           // one bf16 row: 128 bytes
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

// acc = A B^T over d for one q tile: A the consumer's 64 k (or v) rows, B
// the tile's q (or do) rows, both K-major; 4 k steps of 16 over d.
__device__ __forceinline__ void issue_scores(float (&acc)[kBlockM / 2],
                                             uint64_t desc_a,
                                             const __nv_bfloat16* b_tile) {
  const uint64_t desc_b = sm90::desc_sw128(b_tile, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    sm90::wgmma_m64n64k16_ss(acc, desc_a + 2 * kk, desc_b + 2 * kk, kk);
  }
}

// acc += A B over the tile's q rows: A from registers (p^T or ds^T), B the
// tile's do (or q) rows read MN-major; k step ks takes rows 16ks..16ks+15.
__device__ __forceinline__ void issue_accumulate(
    float (&acc)[32], const uint32_t (&a)[kBlockM / 16][4],
    const __nv_bfloat16* b_tile) {
  const uint64_t desc_b = sm90::desc_sw128(b_tile, 1024, 1024);
#pragma unroll
  for (int ks = 0; ks < kBlockM / 16; ++ks) {
    sm90::wgmma_m64n64k16_rs_tb(acc, a[ks],
                                desc_b + ks * (16 * kRowBytes >> 4), 1);
  }
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

// One consumer warpgroup: its 64 kv rows against every q tile, then the
// stores of its dk and dv rows.
__device__ __forceinline__ void consume(Smem& sm, const CUtensorMap* tm_dk,
                                        const CUtensorMap* tm_dv, int c,
                                        int bh, int k0, int skv, int kv_valid,
                                        int n_tiles) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_a = warp * 16 + g;  // this thread's two rows in the 64
  __nv_bfloat16* sk_c = sm.k + c * 64 * kD;
  __nv_bfloat16* sv_c = sm.v + c * 64 * kD;
  const uint64_t desc_k = sm90::desc_sw128(sk_c, 16, 1024);
  const uint64_t desc_v = sm90::desc_sw128(sv_c, 16, 1024);

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  if (n_tiles > 0) sm90::mbar_wait(&sm.kv_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    sm90::mbar_wait(&sm.full[s], (j / kStages) & 1);
    float st[kBlockM / 2], dp[kBlockM / 2];
    sm90::wgmma_fence();
    issue_scores(st, desc_k, sm.q[s]);     // s^T = k q^T
    issue_scores(dp, desc_v, sm.dout[s]);  // dp^T = v do^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(st);
    sm90::fence_regs(dp);
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
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&sm.empty[s]);  // q, do of stage s read
  }

  // dk, dv into this consumer's k and v rows (all its products are done)
  const int row0 = k0 + c * 64;
  const bool keep_a = row0 + r_a < kv_valid, keep_b = row0 + r_a + 8 < kv_valid;
  sm90::named_barrier_sync(1 + c, 128);
  uint8_t* sdk = reinterpret_cast<uint8_t*>(sk_c);
  uint8_t* sdv = reinterpret_cast<uint8_t*>(sv_c);
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

// The producer's second warp: lse and di of every q tile into the stages
// (+inf and 0 for rows past sq, so their p is 0). The next tile's values
// are loaded before the wait for its stage, which hides their latency.
__device__ __forceinline__ void copy_row_stats(Smem& sm, const float* lb,
                                               const float* db, int sq,
                                               int n_tiles) {
  const int lane = threadIdx.x % 32;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    float l[kBlockM / kStatLanes], d[kBlockM / kStatLanes];
#pragma unroll
    for (int r = 0; r < kBlockM / kStatLanes; ++r) {
      const int i = j * kBlockM + r * kStatLanes + lane;
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

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_dk,
                   const __grid_constant__ CUtensorMap tm_dv,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, int sq, int skv,
                   int kv_valid) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = sm90::smem_u32(smem_raw);
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + (((base + 1023) & ~1023u) - base));

  const int warpgroup = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockN;
  // a block wholly past kv_valid only writes its zeros
  const int n_tiles = k0 < kv_valid ? (sq + kBlockM - 1) / kBlockM : 0;

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

  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      sm90::mbar_arrive_expect_tx(&sm.kv_full, 2 * kKVBytes);
      sm90::tma_load_3d(sm.k, &tm_k, &sm.kv_full, 0, k0, bh);
      sm90::tma_load_3d(sm.v, &tm_v, &sm.kv_full, 0, k0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        // the first pass over the ring finds every stage free
        sm90::mbar_wait(&sm.empty[s], ((j / kStages) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * kTileBytes);
        sm90::tma_load_3d(sm.q[s], &tm_q, &sm.full[s], 0, j * kBlockM, bh);
        sm90::tma_load_3d(sm.dout[s], &tm_do, &sm.full[s], 0, j * kBlockM, bh);
      }
    } else if (threadIdx.x / 32 == 1) {
      copy_row_stats(sm, lse + (size_t)bh * sq, di + (size_t)bh * sq, sq,
                     n_tiles);
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume(sm, &tm_dk, &tm_dv, warpgroup - 1, bh, k0, skv, kv_valid,
            n_tiles);
  }
}

int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* di, void* dk, void* dv, int bh,
           int sq, int skv, int kv_valid, cudaStream_t stream) {
  // setmaxnreg.inc waits for registers the producer gives back, so a
  // launch with other than kLaunchRegs a thread would never finish
  cudaFuncAttributes attr;
  cudaError_t st = cudaFuncGetAttributes(&attr, flash_bwd_dkv_sm90);
  if (st != cudaSuccess) return static_cast<int>(st);
  if (attr.numRegs != kLaunchRegs) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv;
  const uint64_t q_head = (uint64_t)sq * kRowBytes;
  const uint64_t kv_head = (uint64_t)skv * kRowBytes;
  int err = sm90::encode_rows_sw128(&tm_q, q, sq, bh, q_head, kBlockM);
  if (!err) err = sm90::encode_rows_sw128(&tm_do, dout, sq, bh, q_head, kBlockM);
  if (!err) err = sm90::encode_rows_sw128(&tm_k, k, kv_valid, bh, kv_head, kBlockN);
  if (!err) err = sm90::encode_rows_sw128(&tm_v, v, kv_valid, bh, kv_head, kBlockN);
  if (!err) err = sm90::encode_rows_sw128(&tm_dk, dk, skv, bh, kv_head, 64);
  if (!err) err = sm90::encode_rows_sw128(&tm_dv, dv, skv, bh, kv_head, 64);
  if (err) return err;
  st = cudaFuncSetAttribute(flash_bwd_dkv_sm90,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            static_cast<int>(kSmemBytes));
  if (st != cudaSuccess) return static_cast<int>(st);
  const dim3 grid((skv + kBlockN - 1) / kBlockN, bh);
  flash_bwd_dkv_sm90<<<grid, kThreads, kSmemBytes, stream>>>(
      tm_q, tm_do, tm_k, tm_v, tm_dk, tm_dv, static_cast<const float*>(lse),
      static_cast<const float*>(di), sq, skv, kv_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k4
}  // namespace ea

extern "C" int ea_flash_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* di, void* dq,
                                    int bh, int sq, int skv, int kv_valid,
                                    int head_dim, void* stream) {
  return ea::launch_attn_bwd_dq<false>(q, k, v, dout, lse, di, dq, bh, sq,
                                       skv, kv_valid, /*window=*/0, head_dim,
                                       stream);
}

extern "C" int ea_flash_bwd_dkv_uses_sm90(int head_dim) {
  return head_dim == ea::k4::kD;
}

extern "C" int ea_flash_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* di,
                                     void* dk, void* dv, int bh, int sq,
                                     int skv, int kv_valid, int head_dim,
                                     void* stream) {
  if (ea_flash_bwd_dkv_uses_sm90(head_dim)) {
    return ea::k4::launch(q, k, v, dout, lse, di, dk, dv, bh, sq, skv,
                          kv_valid, reinterpret_cast<cudaStream_t>(stream));
  }
  return ea::launch_attn_bwd_dkv<false>(q, k, v, dout, lse, di, dk, dv, bh,
                                        sq, skv, kv_valid, /*window=*/0,
                                        head_dim, stream);
}
