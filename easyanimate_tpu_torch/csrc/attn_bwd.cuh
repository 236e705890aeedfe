// The mma.sync backward-attention bodies of K3, K4, K6 and K7 (flash_bwd.cu:
// dense dq and dk, dv; swa_bwd.cu: banded dq and dk, dv) at head dims 16 and
// 32 only; at d 64 all four are TMA + wgmma kernels on bwd_sm90.cuh.
//
// What they compute, given the forward's residuals: q (pre-scaled by
// sm_scale * log2(e)), k, v, do bf16 [bh, S, d] row-major; the base-2
// logsumexp lse f32 [bh, Sq] that K1/K2 saved; di = rowsum(o * do) f32
// [bh, Sq], computed by the wrapper. With p = exp2(q k^T - lse) recomputed
// and ds = p * (do v^T - di):
//   dq = ln2 * ds k          (dq kernel: K3 dense, K6 banded)
//   dk = ln2 * ds^T q,  dv = p^T do   (dkv kernel: K4 dense and K7
//                                      banded, both at d 16/32)
// The ln2 is d exp2(x)/dx; it is applied once at the store, as the TPU dense
// kernels do. Every output has exactly one writer block, so the result is
// deterministic (no atomics).
//
// Design (a simple kernel that is right first):
//   - dq: one block of 4 warps per (64 q rows, b*h). Each warp keeps the
//     bf16 A fragments of its 16 q rows and 16 do rows in registers and
//     walks the kv tiles it can see; per tile it forms s = q k^T and
//     dp = do v^T with mma.sync.m16n8k16, turns them into ds in registers,
//     re-packs ds (as bf16) as the A operand of ds k and accumulates dq in
//     f32 registers.
//   - dkv: one block per (64 kv rows, b*h). Each warp keeps the fragments of
//     its 16 k rows and 16 v rows and computes the TRANSPOSED scores
//     s^T = k q^T and dp^T = v do^T, so p^T and ds^T come out already in
//     the A-operand layout of p^T do and ds^T q; lse and di of the q tile
//     are staged in shared memory because they vary along the columns.
//   - the mask is applied before the exponential: a masked element gets
//     p = 0 without evaluating exp2, so an lse of -inf (a row that sees
//     nothing) can never make inf * 0 = NaN. Columns j >= kv_len and q rows
//     i >= sq are masked by index, so no padded copies are needed and the
//     dk/dv rows in [kv_len, skv) come out exactly 0.
//
// What bounds it on an H100: the backward is 2.5x the forward's matrix
// work (5 products per tile instead of 2) on the same mma.sync path, with
// no load/compute overlap; the dq and dkv kernels each recompute p, which
// is the price of having one writer per output. At d 64 every one of them
// moved onto bwd_sm90.cuh's TMA + wgmma blocks (K6 onto K3's, K7 onto K4's).
#pragma once

#include "attn_fwd.cuh"

namespace ea {

constexpr float kLn2 = 0.69314718055994530942f;
static_assert(kBlockQ == 64 && kBlockKV == 64,
              "the fragment helpers below walk 64-wide tiles");

// A fragments (m16n8k16, row-major 16 x D) of rows [r0, r0 + 16) of a
// shared-memory tile.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t frag[][4],
                                             __nv_bfloat16 (*src)[kRow<D>],
                                             int r0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    frag[kk][0] = ld32(&src[r0 + g][kk * 16 + 2 * t]);
    frag[kk][1] = ld32(&src[r0 + g + 8][kk * 16 + 2 * t]);
    frag[kk][2] = ld32(&src[r0 + g][kk * 16 + 2 * t + 8]);
    frag[kk][3] = ld32(&src[r0 + g + 8][kk * 16 + 2 * t + 8]);
  }
}

// acc[nt] = A (16 x D, fragments `a`) times B^T, B = 64 rows of a
// shared-memory tile: the 16 x 64 score block of this warp.
template <int D>
__device__ __forceinline__ void scores_16x64(float acc[][4],
                                             uint32_t a[][4],
                                             __nv_bfloat16 (*b_rows)[kRow<D>],
                                             int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[2];
      b[0] = ld32(&b_rows[nt * 8 + g][kk * 16 + 2 * t]);
      b[1] = ld32(&b_rows[nt * 8 + g][kk * 16 + 2 * t + 8]);
      mma_16816(acc[nt], a[kk], b);
    }
  }
}

// acc (16 x D) += P (16 x 64, the f32 C fragments `p`, rounded to bf16)
// times the 64 x D shared-memory tile `rows`.
template <int D>
__device__ __forceinline__ void accumulate_pv(float acc[][4],
                                              float p[][4],
                                              __nv_bfloat16 (*rows)[kRow<D>],
                                              int g, int t) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t pa[4];
    pa[0] = pack_f32(p[2 * ks][0], p[2 * ks][1]);
    pa[1] = pack_f32(p[2 * ks][2], p[2 * ks][3]);
    pa[2] = pack_f32(p[2 * ks + 1][0], p[2 * ks + 1][1]);
    pa[3] = pack_f32(p[2 * ks + 1][2], p[2 * ks + 1][3]);
    const int kr = ks * 16 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      uint32_t b[2];
      b[0] = pack_bf16(&rows[kr][dt * 8 + g], &rows[kr + 1][dt * 8 + g]);
      b[1] = pack_bf16(&rows[kr + 8][dt * 8 + g], &rows[kr + 9][dt * 8 + g]);
      mma_16816(acc[dt], pa, b);
    }
  }
}

// Store rows [row_a] and [row_a + 8] of a 16 x D f32 accumulator, times
// `scale`, as bf16; rows at or past `limit` are skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           float acc[][4], int row_a,
                                           int limit, float scale, int t) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < limit) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)row_a * D + col) =
          pack_f32(acc[dt][0] * scale, acc[dt][1] * scale);
    }
    if (row_b < limit) {
      *reinterpret_cast<uint32_t*>(dst + (size_t)row_b * D + col) =
          pack_f32(acc[dt][2] * scale, acc[dt][3] * scale);
    }
  }
}

__device__ __forceinline__ bool visible(int i, int j, int kv_len,
                                        bool windowed, int window) {
  return j < kv_len && (!windowed || abs(i - j) <= window);
}

// dq. kWindowed == false: columns j < kv_len (K3); true: also |i - j| <=
// window (K6), walking only the kv rows [q0 - window, q0 + 64 + window).
template <int D, bool kWindowed>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ di,
                   __nv_bfloat16* __restrict__ dq, int sq, int skv,
                   int kv_len, int window) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockQ][kRow<D>];
  __shared__ __align__(16) __nv_bfloat16 sO[kBlockQ][kRow<D>];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockKV][kRow<D>];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockKV][kRow<D>];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const size_t qoff = (size_t)bh * sq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * skv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * skv * D;

  load_tile<D, kBlockQ>(sQ, q + qoff, q0, sq);
  load_tile<D, kBlockQ>(sO, dout + qoff, q0, sq);
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t qa[D / 16][4], oa[D / 16][4];
  load_a_frags<D>(qa, sQ, r0, g, t);
  load_a_frags<D>(oa, sO, r0, g, t);

  // rows past sq hold zero q and do: any finite lse/di keeps them at ds = 0
  const int row_a = q0 + r0 + g;
  const int row_b = row_a + 8;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = di + (size_t)bh * sq;
  const float lse_a = row_a < sq ? lb[row_a] : 0.f;
  const float lse_b = row_b < sq ? lb[row_b] : 0.f;
  const float di_a = row_a < sq ? db[row_a] : 0.f;
  const float di_b = row_b < sq ? db[row_b] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  int kv_begin = 0, kv_end = kv_len;
  if (kWindowed) {
    kv_begin = max(0, q0 - window);
    kv_end = min(kv_len, q0 + kBlockQ + window);
  }

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // previous tile fully consumed
    load_tile<D, kBlockKV>(sK, kb, kv0, kv_len);
    load_tile<D, kBlockKV>(sV, vb, kv0, kv_len);
    __syncthreads();

    float s[kBlockKV / 8][4], dp[kBlockKV / 8][4];
    scores_16x64<D>(s, qa, sK, g, t);
    scores_16x64<D>(dp, oa, sV, g, t);

    // ds = p * (dp - di), masked before the exponential
#pragma unroll
    for (int nt = 0; nt < kBlockKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = kv0 + nt * 8 + 2 * t + e;
        const float pa = visible(row_a, j, kv_len, kWindowed, window)
                             ? exp2f(s[nt][e] - lse_a) : 0.f;
        const float pb = visible(row_b, j, kv_len, kWindowed, window)
                             ? exp2f(s[nt][2 + e] - lse_b) : 0.f;
        s[nt][e] = pa * (dp[nt][e] - di_a);
        s[nt][2 + e] = pb * (dp[nt][2 + e] - di_b);
      }
    }
    accumulate_pv<D>(acc, s, sK, g, t);  // dq += ds k
  }

  store_rows<D>(dq + qoff, acc, row_a, sq, kLn2, t);
}

// dk, dv. kWindowed == false: rows j < kv_len see every q row i < sq (K4);
// true: only |i - j| <= window (K7), walking q rows
// [k0 - window, k0 + 64 + window).
template <int D, bool kWindowed>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ di,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int sq, int skv,
                    int kv_len, int window) {
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockKV][kRow<D>];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockKV][kRow<D>];
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockQ][kRow<D>];
  __shared__ __align__(16) __nv_bfloat16 sO[kBlockQ][kRow<D>];
  __shared__ float sL[kBlockQ];
  __shared__ float sD[kBlockQ];

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  const size_t koff = (size_t)bh * skv * D;
  const __nv_bfloat16* qb = q + (size_t)bh * sq * D;
  const __nv_bfloat16* ob = dout + (size_t)bh * sq * D;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = di + (size_t)bh * sq;

  load_tile<D, kBlockKV>(sK, k + koff, k0, kv_len);
  load_tile<D, kBlockKV>(sV, v + koff, k0, kv_len);
  __syncthreads();

  const int r0 = warp * 16;
  uint32_t ka[D / 16][4], va[D / 16][4];
  load_a_frags<D>(ka, sK, r0, g, t);
  load_a_frags<D>(va, sV, r0, g, t);

  const int row_a = k0 + r0 + g;  // this thread's two kv rows
  const int row_b = row_a + 8;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    dk_acc[dt][0] = dk_acc[dt][1] = dk_acc[dt][2] = dk_acc[dt][3] = 0.f;
    dv_acc[dt][0] = dv_acc[dt][1] = dv_acc[dt][2] = dv_acc[dt][3] = 0.f;
  }

  int q_begin = 0, q_end = sq;
  if (kWindowed) {
    q_begin = max(0, k0 - window);
    q_end = min(sq, k0 + kBlockKV + window);
  }

  for (int i0 = q_begin; i0 < q_end; i0 += kBlockQ) {
    __syncthreads();  // previous tile fully consumed
    load_tile<D, kBlockQ>(sQ, qb, i0, sq);
    load_tile<D, kBlockQ>(sO, ob, i0, sq);
    for (int c = threadIdx.x; c < kBlockQ; c += kThreads) {
      const int i = i0 + c;
      sL[c] = i < sq ? lb[i] : 0.f;
      sD[c] = i < sq ? db[i] : 0.f;
    }
    __syncthreads();

    float s[kBlockQ / 8][4], dp[kBlockQ / 8][4];
    scores_16x64<D>(s, ka, sQ, g, t);   // s^T = k q^T
    scores_16x64<D>(dp, va, sO, g, t);  // dp^T = v do^T

    // p^T stays in s, ds^T goes to dp; masked before the exponential
#pragma unroll
    for (int nt = 0; nt < kBlockQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t + e;
        const int i = i0 + c;
        const bool in_q = i < sq;
        const float pa = in_q && visible(i, row_a, kv_len, kWindowed, window)
                             ? exp2f(s[nt][e] - sL[c]) : 0.f;
        const float pb = in_q && visible(i, row_b, kv_len, kWindowed, window)
                             ? exp2f(s[nt][2 + e] - sL[c]) : 0.f;
        s[nt][e] = pa;
        s[nt][2 + e] = pb;
        dp[nt][e] = pa * (dp[nt][e] - sD[c]);
        dp[nt][2 + e] = pb * (dp[nt][2 + e] - sD[c]);
      }
    }
    accumulate_pv<D>(dv_acc, s, sO, g, t);   // dv += p^T do
    accumulate_pv<D>(dk_acc, dp, sQ, g, t);  // dk += ds^T q
  }

  store_rows<D>(dk + koff, dk_acc, row_a, skv, kLn2, t);
  store_rows<D>(dv + koff, dv_acc, row_a, skv, 1.f, t);
}

template <bool kWindowed>
int launch_attn_bwd_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dq, int bh, int sq, int skv, int kv_len,
                       int window, int head_dim, void* stream) {
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, bh);
  const dim3 block(kThreads);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(di);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  switch (head_dim) {
    case 16:
      attn_bwd_dq_kernel<16, kWindowed><<<grid, block, 0, st>>>(
          qp, kp, vp, op, lp, dp, dqp, sq, skv, kv_len, window);
      break;
    case 32:
      attn_bwd_dq_kernel<32, kWindowed><<<grid, block, 0, st>>>(
          qp, kp, vp, op, lp, dp, dqp, sq, skv, kv_len, window);
      break;
    case 64:
      // dense d 64 is flash_bwd.cu's TMA + wgmma kernel: no instance here
      if constexpr (kWindowed) {
        attn_bwd_dq_kernel<64, kWindowed><<<grid, block, 0, st>>>(
            qp, kp, vp, op, lp, dp, dqp, sq, skv, kv_len, window);
        break;
      } else {
        return static_cast<int>(cudaErrorInvalidValue);
      }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kWindowed>
int launch_attn_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* di,
                        void* dk, void* dv, int bh, int sq, int skv,
                        int kv_len, int window, int head_dim, void* stream) {
  const dim3 grid((skv + kBlockKV - 1) / kBlockKV, bh);
  const dim3 block(kThreads);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* op = static_cast<const __nv_bfloat16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* dp = static_cast<const float*>(di);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  switch (head_dim) {
    case 16:
      attn_bwd_dkv_kernel<16, kWindowed><<<grid, block, 0, st>>>(
          qp, kp, vp, op, lp, dp, dkp, dvp, sq, skv, kv_len, window);
      break;
    case 32:
      attn_bwd_dkv_kernel<32, kWindowed><<<grid, block, 0, st>>>(
          qp, kp, vp, op, lp, dp, dkp, dvp, sq, skv, kv_len, window);
      break;
    default:  // d 64: flash_bwd.cu's and swa_bwd.cu's TMA + wgmma kernels

      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ea
