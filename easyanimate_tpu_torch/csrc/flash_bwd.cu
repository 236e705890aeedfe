// K3 and K4: dense flash-attention backward for the MMDiT joint text+video
// attention and the SWA cross pass (the training step's gradient of K1).
//
// Replaces the TPU kernels easyanimate_tpu/ops/flash_attention.py::
// _bwd_dq_kernel (K3) and ::_bwd_dkv_kernel (K4), driven by _flash_bwd. The
// TPU kernels carry the dq / dk, dv sums in VMEM scratch across their
// sequential grid axis and rely on zero-padded k and v: there the pad
// columns get p = 2^(-lse), not 0, and the wrapper slices the pad rows'
// dk/dv away. Here a CUDA block loops over the tiles itself, and the pad
// columns are masked by index, so the dk/dv rows in [kv_valid, skv) come
// out exactly 0 and no padded copies exist.
//
// Bound on the H100: at the dense flagship shape (b*h = 96, S = 13,360,
// d = 64) K3 runs 3 products of 2*S^2*d per head (6.6 TFLOP, 6.653 ms at
// 989 TFLOP/s) and K4 runs 4 (8.871 ms) against ~0.1 GB of q/k/v/do/dq/dk/
// dv traffic each: both are bound by operations.
//
// At head_dim 64 (every production preset) both are warp-specialised TMA +
// wgmma kernels on hopper.cuh, with the pieces they share (and share with
// K6 and K7, swa_bwd.cu) in bwd_sm90.cuh, and one split: a block of 3
// warpgroups (384 threads, 168 registers a thread at launch); warpgroup 0 is
// the producer (24 registers by setmaxnreg), whose elected thread loads the
// block's own rows once by TMA and streams the other side's tiles through a
// ring of kStages shared-memory stages (full/empty mbarriers); warpgroups
// 1-2 are consumers (240 registers), each owning 64 of the block's rows.
// Tensor maps are 3-D (d, rows, b*h): rows past a map's extent arrive as
// zeros and no tile reads another head's rows. Every output row has one
// writer block, so there are no atomics and the result is deterministic.
// Each epilogue writes its bf16 rows into the consumer's finished operand
// rows of shared memory (128-byte swizzle) and stores them by one TMA store,
// which clips rows past the tensor's end.
//
// K3, flash_bwd_dq_sm90 (dq = ln2 * ds k), K1's walk (flash_fwd.cu) with one
// more score product, on bwd_sm90.cuh's dq block, which K6 walks over its
// band only:
//   - a block per (128 q rows, b*h); its q and do rows arrive once, k and v
//     stream in 64-row tiles through a 4-stage ring (their maps take
//     kv_valid as the extent);
//   - lse and di vary along the rows here, so each consumer thread loads its
//     two rows' values once into registers (+inf and 0 past Sq, so p = 0
//     and ds = 0 there); their head stride, 4 * Sq bytes, never meets TMA;
//   - per kv tile: s = q k^T and dp = do v^T (SS wgmma m64n64, both
//     operands K-major), then in registers p = exp2(s - lse) and ds =
//     p (dp - di), packed to bf16 as the A fragments of dq += ds k (RS
//     wgmma, k read MN-major from the same stage: K1's p v). The stage is
//     released once wgmma.wait_group shows that product complete;
//   - the zero k rows past kv_valid score s = 0, so p = 2^(-lse), which
//     overflows to inf once lse < -128 (and inf * 0 is NaN): on the last
//     tile, and only there, columns >= kv_valid get s = -inf first (K1's
//     last-tile test; K6 applies it to the tile that crosses S).
//   Per kv tile a consumer runs 3 products of 2 * 64 * 64 * 64 (~384
//   tensor-core cycles at the peak) against 4,096 exponentials (~256 cycles
//   on the MUFU units): the products lead, and the two consumers fill each
//   other's elementwise gaps.
//
// K4, flash_bwd_dkv_sm90 (dk = ln2 * ds^T q, dv = p^T do), on
// bwd_sm90.cuh's dk/dv block, which K7 walks over its band only:
//   - a block per (128 kv rows, b*h); its k and v rows arrive once and stay
//     as the A operands of the two score products, its dk and dv sums
//     (64 x 64 f32 each) stay in registers for the whole q loop;
//   - q and do stream in kBlockM-row tiles (rows past Sq arrive as zeros).
//     lse and di vary along the columns here and cannot come by TMA (their
//     head stride need not be a multiple of 16), so the producer's second
//     warp copies each stage's slice into shared memory with plain loads
//     (lse = +inf past Sq, so p = 0 there) and arrives on the stage's full
//     barrier too;
//   - per q tile a consumer computes the TRANSPOSED scores s^T = k q^T and
//     dp^T = v do^T (SS wgmma), then p^T = exp2(s^T - lse[col]) and ds^T =
//     p^T (dp^T - di[col]) in registers, packed as the A fragments of dv +=
//     p^T do and dk += ds^T q (RS wgmma, do and q read MN-major);
//   - kv rows at or past kv_valid arrive as zero k and v rows, whose p^T is
//     2^(-lse), not 0. A row of dv (dk) depends only on the same row of p^T
//     (ds^T), so the epilogue writes those rows as exact zeros instead of
//     masking every tile; blocks wholly past kv_valid skip the q loop.
//   Per 64-row q tile a block runs 4 products of 2 * 128 * 64 * 64 (~1,024
//   tensor-core cycles at the peak) against 8,192 exponentials (~512 cycles
//   on the MUFU units).
//
// Tried on the card and dropped (PERF.md). ptxas fitted the consumers'
// code into the launch's 168 registers, not setmaxnreg's 240: K3 with
// 128-column kv tiles (2 stages) spilled dq (384 B) with about 180 values
// live, beside the two 64-float score accumulators, and ran 1.2x slower;
// issuing tile j + 1's score products right behind tile j's dq product,
// without a wait between, ran 1.25x slower. K4: 128-row q
// tiles and 3 consumers (192 kv rows at 160 registers) both spill; issuing
// the next tile's score products ahead of this tile's accumulating ones
// spilled. Two and three stages time alike.
//
// Head dims 16 and 32 (the tiny test preset only) run the mma.sync bodies of
// attn_bwd.cuh: a dispatch by shape in the entry points below, never a
// fallback on failure. ea_flash_bwd_uses_sm90 tells the wrapper which ran.
#include "bwd_sm90.cuh"

namespace ea {

namespace k3 {

using namespace bwd90;
using namespace bwd90::dq;

// One consumer warpgroup: its 64 q rows against every kv tile, then the
// store of its dq rows.
__device__ __forceinline__ void consume(Smem& sm, const CUtensorMap* tm_dq,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ di, int c,
                                        int bh, int q0, int sq, int kv_valid,
                                        int n_tiles) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_a = warp * 16 + g;  // this thread's two rows in the 64
  const int row0 = q0 + c * 64;
  const uint64_t desc_q = sm90::desc_sw128(sm.q + c * 64 * kD, 16, 1024);
  const uint64_t desc_do = sm90::desc_sw128(sm.dout + c * 64 * kD, 16, 1024);
  const RowStats st = row_stats(lse, di, bh, sq, row0 + r_a);

  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  sm90::mbar_wait(&sm.q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    sm90::mbar_wait(&sm.full[s], (j / kStages) & 1);
    float sc[kBlockN / 2], dp[kBlockN / 2];
    tile_scores(sc, dp, desc_q, desc_do, sm, s);
    uint32_t da[kBlockN / 16][4];
    ds_tile(sc, dp, st, j * kBlockN, kv_valid, t, da);
    tile_accumulate(dq, da, sm, s, lane);
  }
  store_dq(sm, tm_dq, dq, c, bh, row0, sq);
}

// The block's prologue and producer are bwd_sm90.cuh's dq::init_smem and
// dq::produce written out: calling either helper here changes which of the
// block indices ptxas keeps in uniform registers, and with them 15 opcode
// counts of K3's integer address arithmetic (its products and exponentials
// stay). Written out, K3's SASS opcode counts are those of its own design.
__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_do,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_dq,
                  const float* __restrict__ lse,
                  const float* __restrict__ di, int sq, int kv_valid) {
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
      sm90::mbar_arrive_expect_tx(&sm.q_full, 2 * kQBytes);
      sm90::tma_load_3d(sm.q, &tm_q, &sm.q_full, 0, q0, bh);
      sm90::tma_load_3d(sm.dout, &tm_do, &sm.q_full, 0, q0, bh);
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
    consume(sm, &tm_dq, lse, di, warpgroup - 1, bh, q0, sq, kv_valid,
            n_tiles);
  }
}

int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* di, void* dq, int bh, int sq,
           int skv, int kv_valid, cudaStream_t stream) {
  int err = sm90::check_launch_regs(flash_bwd_dq_sm90, kLaunchRegs);
  if (err) return err;
  Maps m;
  err = encode_maps(m, q, dout, k, v, dq, bh, sq, skv, kv_valid);
  if (err) return err;
  const cudaError_t st = cudaFuncSetAttribute(
      flash_bwd_dq_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (st != cudaSuccess) return static_cast<int>(st);
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  flash_bwd_dq_sm90<<<grid, kBlockThreads, kSmemBytes, stream>>>(
      m.q, m.dout, m.k, m.v, m.dq, static_cast<const float*>(lse),
      static_cast<const float*>(di), sq, kv_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k3

namespace k4 {

using namespace bwd90;
using namespace bwd90::dkv;

// One consumer warpgroup: its 64 kv rows against every q tile, then the
// stores of its dk and dv rows.
__device__ __forceinline__ void consume(Smem& sm, const CUtensorMap* tm_dk,
                                        const CUtensorMap* tm_dv, int c,
                                        int bh, int k0, int skv, int kv_valid,
                                        int n_tiles) {
  const int lane = threadIdx.x % 32;
  const int t = lane % 4;
  const uint64_t desc_k = sm90::desc_sw128(sm.k + c * 64 * kD, 16, 1024);
  const uint64_t desc_v = sm90::desc_sw128(sm.v + c * 64 * kD, 16, 1024);

  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

  if (n_tiles > 0) sm90::mbar_wait(&sm.kv_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    sm90::mbar_wait(&sm.full[s], (j / kStages) & 1);
    float st[kBlockM / 2], dp[kBlockM / 2];
    tile_scores(st, dp, desc_k, desc_v, sm, s);
    tile_accumulate(dk, dv, st, dp, sm, s, t, lane);
  }
  store_dk_dv(sm, tm_dk, tm_dv, dk, dv, c, bh, k0 + c * 64, kv_valid, skv);
}

__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_dk,
                   const __grid_constant__ CUtensorMap tm_dv,
                   const float* __restrict__ lse,
                   const float* __restrict__ di, int sq, int skv,
                   int kv_valid) {
  Smem& sm = init_smem();
  const int warpgroup = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockN;
  // a block wholly past kv_valid only writes its zeros
  const int n_tiles = k0 < kv_valid ? (sq + kBlockM - 1) / kBlockM : 0;
  if (warpgroup == 0) {
    produce(sm, &tm_q, &tm_do, &tm_k, &tm_v, lse, di, bh, sq, k0,
            /*q_begin=*/0, n_tiles);
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    consume(sm, &tm_dk, &tm_dv, warpgroup - 1, bh, k0, skv, kv_valid,
            n_tiles);
  }
}

int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* di, void* dk, void* dv, int bh,
           int sq, int skv, int kv_valid, cudaStream_t stream) {
  int err = sm90::check_launch_regs(flash_bwd_dkv_sm90, kLaunchRegs);
  if (err) return err;
  Maps m;
  err = encode_maps(m, q, dout, k, v, dk, dv, bh, sq, skv, kv_valid);
  if (err) return err;
  const cudaError_t st = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (st != cudaSuccess) return static_cast<int>(st);
  const dim3 grid((skv + kBlockN - 1) / kBlockN, bh);
  flash_bwd_dkv_sm90<<<grid, kBlockThreads, kSmemBytes, stream>>>(
      m.q, m.dout, m.k, m.v, m.dk, m.dv, static_cast<const float*>(lse),
      static_cast<const float*>(di), sq, skv, kv_valid);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k4
}  // namespace ea

extern "C" int ea_flash_bwd_uses_sm90(int head_dim) {
  return head_dim == ea::bwd90::kD;
}

extern "C" int ea_flash_bwd_dq_bf16(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* di, void* dq,
                                    int bh, int sq, int skv, int kv_valid,
                                    int head_dim, void* stream) {
  if (ea_flash_bwd_uses_sm90(head_dim)) {
    return ea::k3::launch(q, k, v, dout, lse, di, dq, bh, sq, skv, kv_valid,
                          reinterpret_cast<cudaStream_t>(stream));
  }
  return ea::launch_attn_bwd_dq<false>(q, k, v, dout, lse, di, dq, bh, sq,
                                       skv, kv_valid, /*window=*/0, head_dim,
                                       stream);
}

extern "C" int ea_flash_bwd_dkv_bf16(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* di,
                                     void* dk, void* dv, int bh, int sq,
                                     int skv, int kv_valid, int head_dim,
                                     void* stream) {
  if (ea_flash_bwd_uses_sm90(head_dim)) {
    return ea::k4::launch(q, k, v, dout, lse, di, dk, dv, bh, sq, skv,
                          kv_valid, reinterpret_cast<cudaStream_t>(stream));
  }
  return ea::launch_attn_bwd_dkv<false>(q, k, v, dout, lse, di, dk, dv, bh,
                                        sq, skv, kv_valid, /*window=*/0,
                                        head_dim, stream);
}
