// The mma.sync forward-attention body of K1 (flash_fwd.cu: dense), K2
// (swa_fwd.cu: banded) and K5 (swa_fused_fwd.cu: banded + global) at head
// dims 16 and 32 (the tiny test preset), and of K1 at head dim 144 past
// 64 q or kv rows; at d 64 all three are TMA + wgmma kernels on
// fwd_sm90.cuh, and so is K1 at d 88 and 72 (fwd_split_sm90.cuh) and at
// d 72 and 144 on heads of at most 64 q and kv rows (fwd_short_sm90.cuh:
// V1-V3's temporal passes).
//
// What it computes: o = softmax2(q k^T) v and the base-2 logsumexp per row,
// where q arrives pre-scaled by sm_scale * log2(e) (the wrapper folds it in
// and rounds back to bf16), so the softmax is exp2(s - m). Inputs are bf16
// [bh, S, d] row-major, o is bf16 [bh, Sq, d], lse is f32 [bh, Sq].
//
// Design (a simple kernel that is right first):
//   - one block of 4 warps per (q tile of 64 rows, b*h), both folded into
//     blockIdx.x (the q tiles of a head adjacent), so b*h may pass
//     gridDim.y's 65,535 (V3's temporal pass at 768x768: 73,728); each warp
//     owns 16 q rows and keeps their bf16 A fragments in registers for the
//     whole kv loop;
//   - kv streams through shared memory in tiles of 64 rows (k and v), with
//     a __syncthreads fence around each load (no double buffering); rows
//     padded to kRow<D> so fragment loads do not conflict in the banks. The
//     tiles are dynamic shared memory: at d 144 the q, k and v tiles take
//     57 KB, past the 48 KB a static allocation may hold;
//   - both products are mma.sync.m16n8k16 bf16 -> f32; the f32 score
//     fragment of q k^T is re-packed in registers as the A operand of p v
//     (the usual register-level FA2 layout trick), so p never touches
//     shared memory;
//   - running max / sum in f32, rows reduced across the 4 threads of a quad
//     with shuffles;
//   - the ragged edge is masked by column index (s = -inf), so no padded
//     copies are needed; a row whose sum stays 0 gets l_inv = 1 (o = 0).
//
// What bounds it on an H100: at head_dim 64 each kv element loaded from
// shared memory feeds 64 q rows, and the mma.sync path reaches a fraction
// of the wgmma peak; with no load/compute overlap the tensor cores idle
// during every tile load. hopper.cuh, fwd_sm90.cuh and fwd_split_sm90.cuh
// hold the TMA + wgmma + producer warpgroup pieces K1, K2 and K5 moved
// onto. At d 88 this body ran V4's self attention [32, 36864, 88] in
// 101.95 ms on an NVIDIA H100 80GB HBM3 at 700 W, 15% of its 15.48 ms
// bound and 2.9x SDPA's time there: the reason K1 took the TMA + wgmma
// design at 88 and 72. At d 144 it ran V2's temporal pass [16,384, 36,
// 144] in 0.504 ms (40% of its bytes bound), one 64-row block a head that
// loads before it computes: the reason those passes moved to
// flash_fwd_short_sm90.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ea {

constexpr int kBlockQ = 64;
constexpr int kBlockKV = 64;

// Shared-memory row length of a [rows, D] bf16 tile: rows 16-byte aligned
// (each is loaded as 16-byte chunks), and a row stride of 4 words past a
// multiple of 8, so that the 8 rows (g) one fragment load touches fall in 8
// distinct groups of 4 banks: D + 8 for d 16, 32 and 144 (12, 20 and 76
// words).
template <int D>
constexpr int kRow = D + 8;
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x is the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  const uint32_t l = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t h = *reinterpret_cast<const uint16_t*>(hi);
  return l | (h << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Copy rows [row0, row0 + kRows) of a [*, D] bf16 matrix into shared memory
// (row stride kRow<D>), zero-filling rows at or past `limit`.
template <int D, int kRows>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[kRow<D>],
                                          const __nv_bfloat16* src, int row0,
                                          int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    }
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

// One thread's share of the online softmax over a q tile: the running max
// and partial sum of its two rows, and its fragment of the f32 accumulator.
template <int D>
struct SoftmaxState {
  float m_a, m_b, l_a, l_b;
  float acc[D / 8][4];

  __device__ __forceinline__ void reset() {
    m_a = m_b = -INFINITY;
    l_a = l_b = 0.f;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
    }
  }

  // Sum the quad's partial row sums into l; 1/l, or 1 for a row that saw
  // nothing (its acc is 0, so o = 0).
  __device__ __forceinline__ void finish(float& inv_a, float& inv_b) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    inv_a = l_a <= 0.f ? 1.f : 1.f / l_a;
    inv_b = l_b <= 0.f ? 1.f : 1.f / l_b;
  }
};

// One warp's 16 q rows as bf16 A fragments, one per 16 columns of d.
template <int D>
struct QFrags {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int kSteps = D / 16;  // m16n8k16 steps
  uint32_t a[kSteps][4];
};

// Load this warp's 16 q rows of sQ as bf16 A fragments.
template <int D>
__device__ __forceinline__ void load_q_frags(QFrags<D>& qa,
                                             __nv_bfloat16 (*sQ)[kRow<D>],
                                             int r0, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < QFrags<D>::kSteps; ++kk) {
    qa.a[kk][0] = ld32(&sQ[r0 + g][kk * 16 + 2 * t]);
    qa.a[kk][1] = ld32(&sQ[r0 + g + 8][kk * 16 + 2 * t]);
    qa.a[kk][2] = ld32(&sQ[r0 + g][kk * 16 + 2 * t + 8]);
    qa.a[kk][3] = ld32(&sQ[r0 + g + 8][kk * 16 + 2 * t + 8]);
  }
}

// Stream the kv rows [kv_begin, kv_end) of kb, vb through sK, sV in tiles of
// kBlockKV and fold them into `st`. Columns j < kv_len are visible, and with
// kWindowed only those with |i - j| <= window. Every thread of the block
// must call it (it fences with __syncthreads).
template <int D, bool kWindowed>
__device__ __forceinline__ void attend_tiles(
    SoftmaxState<D>& st, const QFrags<D>& qa,
    __nv_bfloat16 (*sK)[kRow<D>], __nv_bfloat16 (*sV)[kRow<D>],
    const __nv_bfloat16* kb, const __nv_bfloat16* vb, int kv_begin,
    int kv_end, int kv_len, int window, int row_a, int row_b, int g, int t) {
  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += kBlockKV) {
    __syncthreads();  // previous tile fully consumed
    load_tile<D, kBlockKV>(sK, kb, kv0, kv_len);
    load_tile<D, kBlockKV>(sV, vb, kv0, kv_len);
    __syncthreads();

    float s[kBlockKV / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockKV / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < QFrags<D>::kSteps; ++kk) {
        uint32_t b[2];
        b[0] = ld32(&sK[nt * 8 + g][kk * 16 + 2 * t]);
        b[1] = ld32(&sK[nt * 8 + g][kk * 16 + 2 * t + 8]);
        mma_16816(s[nt], qa.a[kk], b);
      }
    }

    // mask by column index, then the tile's row max
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kBlockKV / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = kv0 + nt * 8 + 2 * t + e;
        bool ok_a = j < kv_len, ok_b = j < kv_len;
        if (kWindowed) {
          ok_a = ok_a && abs(row_a - j) <= window;
          ok_b = ok_b && abs(row_b - j) <= window;
        }
        if (!ok_a) s[nt][e] = -INFINITY;
        if (!ok_b) s[nt][2 + e] = -INFINITY;
        mx_a = fmaxf(mx_a, s[nt][e]);
        mx_b = fmaxf(mx_b, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(st.m_a, mx_a), mn_b = fmaxf(st.m_b, mx_b);
    // a row with nothing visible yet keeps m = -inf; exponentiate against 0
    const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float alpha_a = exp2f(st.m_a - mu_a), alpha_b = exp2f(st.m_b - mu_b);
    st.m_a = mn_a;
    st.m_b = mn_b;

    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kBlockKV / 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mu_a);
      s[nt][1] = exp2f(s[nt][1] - mu_a);
      s[nt][2] = exp2f(s[nt][2] - mu_b);
      s[nt][3] = exp2f(s[nt][3] - mu_b);
      sum_a += s[nt][0] + s[nt][1];
      sum_b += s[nt][2] + s[nt][3];
    }
    st.l_a = st.l_a * alpha_a + sum_a;
    st.l_b = st.l_b * alpha_b + sum_b;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      st.acc[dt][0] *= alpha_a;
      st.acc[dt][1] *= alpha_a;
      st.acc[dt][2] *= alpha_b;
      st.acc[dt][3] *= alpha_b;
    }

    // o += p v: the score fragments of two adjacent 8-column tiles form the
    // A fragment of one 16-deep k step
#pragma unroll
    for (int ks = 0; ks < kBlockKV / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_f32(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_f32(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_f32(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_f32(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const int kr = ks * 16 + 2 * t;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t b[2];
        b[0] = pack_bf16(&sV[kr][dt * 8 + g], &sV[kr + 1][dt * 8 + g]);
        b[1] = pack_bf16(&sV[kr + 8][dt * 8 + g], &sV[kr + 9][dt * 8 + g]);
        mma_16816(st.acc[dt], pa, b);
      }
    }
  }
}

// The q, k and v tiles' bytes (dynamic shared memory).
template <int D>
constexpr int kFwdSmemBytes = (kBlockQ + 2 * kBlockKV) * kRow<D> * 2;

// kWindowed == false: columns j < kv_len are visible (dense: K1 at d 16,
// 32 and 144).
// kWindowed == true:  columns j < kv_len with |i - j| <= window (K2).
template <int D, bool kWindowed>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                int sq, int skv, int kv_len, int window) {
  extern __shared__ __align__(16) uint8_t attn_fwd_smem[];
  auto* sQ = reinterpret_cast<__nv_bfloat16 (*)[kRow<D>]>(attn_fwd_smem);
  auto* sK = sQ + kBlockQ;
  auto* sV = sK + kBlockKV;

  const int n_qt = (sq + kBlockQ - 1) / kBlockQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x - bh * n_qt) * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // row within the 8-row half of the fragment
  const int t = lane % 4;  // thread within the quad

  const __nv_bfloat16* qb = q + (size_t)bh * sq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * skv * D;
  const __nv_bfloat16* vb = v + (size_t)bh * skv * D;

  load_tile<D, kBlockQ>(sQ, qb, q0, sq);
  __syncthreads();

  const int r0 = warp * 16;
  QFrags<D> qa;
  load_q_frags<D>(qa, sQ, r0, g, t);

  const int row_a = q0 + r0 + g;  // this thread's two rows
  const int row_b = row_a + 8;
  SoftmaxState<D> st;
  st.reset();

  int kv_begin = 0, kv_end = kv_len;
  if (kWindowed) {
    kv_begin = max(0, q0 - window);
    kv_end = min(kv_len, q0 + kBlockQ + window);
  }
  attend_tiles<D, kWindowed>(st, qa, sK, sV, kb, vb, kv_begin, kv_end, kv_len,
                             window, row_a, row_b, g, t);

  float inv_a, inv_b;
  st.finish(inv_a, inv_b);
  __nv_bfloat16* ob = o + (size_t)bh * sq * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < sq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_a * D + col) =
          pack_f32(st.acc[dt][0] * inv_a, st.acc[dt][1] * inv_a);
    }
    if (row_b < sq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_b * D + col) =
          pack_f32(st.acc[dt][2] * inv_b, st.acc[dt][3] * inv_b);
    }
  }
  if (t == 0) {
    float* lb = lse + (size_t)bh * sq;
    if (row_a < sq) lb[row_a] = st.m_a + log2f(fmaxf(st.l_a, 1e-30f));
    if (row_b < sq) lb[row_b] = st.m_b + log2f(fmaxf(st.l_b, 1e-30f));
  }
}

template <int D, bool kWindowed>
int launch_attn_fwd_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
                      const __nv_bfloat16* v, __nv_bfloat16* o, float* lse,
                      int bh, int sq, int skv, int kv_len, int window,
                      cudaStream_t st) {
  constexpr int bytes = kFwdSmemBytes<D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_fwd_kernel<D, kWindowed>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((sq + kBlockQ - 1) / kBlockQ) * bh);
  attn_fwd_kernel<D, kWindowed><<<grid, kThreads, bytes, st>>>(
      q, k, v, o, lse, sq, skv, kv_len, window);
  return static_cast<int>(cudaGetLastError());
}

template <bool kWindowed>
int launch_attn_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, int bh, int sq, int skv, int kv_len,
                    int window, int head_dim, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto* lp = static_cast<float*>(lse);
  switch (head_dim) {
    case 16:
      return launch_attn_fwd_d<16, kWindowed>(qp, kp, vp, op, lp, bh, sq,
                                              skv, kv_len, window, st);
    case 32:
      return launch_attn_fwd_d<32, kWindowed>(qp, kp, vp, op, lp, bh, sq,
                                              skv, kv_len, window, st);
    // K1 only: its wrapper refuses 144 for K2 (KERNEL_HEAD_DIMS)
    case 144:
      if constexpr (!kWindowed) {
        return launch_attn_fwd_d<144, false>(qp, kp, vp, op, lp, bh, sq, skv,
                                             kv_len, window, st);
      }
      break;
    // d 64 runs the TMA + wgmma kernels (flash_fwd.cu, swa_fwd.cu), and so
    // do K1's d 88 and 72: no instance here
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace ea
