// K5: fused local + global sliding-window attention forward: the windowed
// softmax of the SWA local pass and the independent softmax of its global
// "cross" pass, each normalised, summed at the store (the reference adds the
// two normalised outputs, processor.py:436).
//
// Replaces the TPU kernel easyanimate_tpu/ops/swa.py::_swa_fused_kernel
// (driven by _swa_local_global_fwd). The TPU kernel reads one kv input that
// its wrapper builds per layer by concatenation, [local | pad | global |
// pad] (kv_aug / vv_aug), walks window offsets and then the global tiles on
// its sequential grid axis, and removes both pad masses in closed form at
// the store. Here the local k, v [bh, S, d] and the global gk, gv
// [bh, Sg, d] stay separate pointers, so no per-layer copy is made: each
// block of 64 q rows walks the local rows [q0 - W, q0 + 64 + W) into one
// set of row stats, finishes o_local = acc / l, then walks the Sg global
// rows into a second set and stores o_local + acc / l. Both walks mask by
// column index (j < S and |i - j| <= W; j < Sg), as K1 and K2 do.
//
// Bound on the H100: at the flagship shape (bh 96, S 13,104, d 64, W 1,008,
// Sg 1,027) the band needs 4 S (2W + 1) d bh ~ 0.65 TFLOP and the global
// pass 4 S Sg d bh ~ 0.33 TFLOP: ~0.98 TFLOP, ~1.0 ms at the 989 TFLOP/s
// bf16 peak, against ~0.67 GB of traffic (~0.2 ms): compute-bound. Register
// pressure is the thing to watch: next to the live accumulator each thread
// holds the finished local output (D / 8 x 4 floats more than K1/K2 carry;
// K4 at 232 registers already runs 2 blocks per SM). The body is K1/K2's
// mma.sync loop (attn_fwd.cuh), with the same lack of copy/compute overlap.
#include "attn_fwd.cuh"

namespace ea {

template <int D>
__global__ void __launch_bounds__(kThreads)
swa_fused_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ gk,
                     const __nv_bfloat16* __restrict__ gv,
                     __nv_bfloat16* __restrict__ o, int s, int sg,
                     int window) {
  __shared__ __align__(16) __nv_bfloat16 sQ[kBlockQ][D + 8];
  __shared__ __align__(16) __nv_bfloat16 sK[kBlockKV][D + 8];
  __shared__ __align__(16) __nv_bfloat16 sV[kBlockKV][D + 8];

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;

  load_tile<D, kBlockQ>(sQ, q + (size_t)bh * s * D, q0, s);
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qa[D / 16][4];
  load_q_frags<D>(qa, sQ, r0, g, t);
  const int row_a = q0 + r0 + g;
  const int row_b = row_a + 8;

  // stats set 1: the band of the permuted video tokens
  SoftmaxState<D> st;
  st.reset();
  attend_tiles<D, true>(st, qa, sK, sV, k + (size_t)bh * s * D,
                        v + (size_t)bh * s * D, max(0, q0 - window),
                        min(s, q0 + kBlockQ + window), s, window, row_a,
                        row_b, g, t);
  float inv_a, inv_b;
  st.finish(inv_a, inv_b);
  float out[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    out[dt][0] = st.acc[dt][0] * inv_a;
    out[dt][1] = st.acc[dt][1] * inv_a;
    out[dt][2] = st.acc[dt][2] * inv_b;
    out[dt][3] = st.acc[dt][3] * inv_b;
  }

  // stats set 2: every query against all Sg global rows
  st.reset();
  attend_tiles<D, false>(st, qa, sK, sV, gk + (size_t)bh * sg * D,
                         gv + (size_t)bh * sg * D, 0, sg, sg, 0, row_a, row_b,
                         g, t);
  st.finish(inv_a, inv_b);

  __nv_bfloat16* ob = o + (size_t)bh * s * D;
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < s) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_a * D + col) =
          pack_f32(out[dt][0] + st.acc[dt][0] * inv_a,
                   out[dt][1] + st.acc[dt][1] * inv_a);
    }
    if (row_b < s) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_b * D + col) =
          pack_f32(out[dt][2] + st.acc[dt][2] * inv_b,
                   out[dt][3] + st.acc[dt][3] * inv_b);
    }
  }
}

}  // namespace ea

extern "C" int ea_swa_fused_fwd_bf16(const void* q, const void* k,
                                     const void* v, const void* gk,
                                     const void* gv, void* o, int bh, int s,
                                     int sg, int window, int head_dim,
                                     void* stream) {
  const dim3 grid((s + ea::kBlockQ - 1) / ea::kBlockQ, bh);
  const dim3 block(ea::kThreads);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  const auto* gkp = static_cast<const __nv_bfloat16*>(gk);
  const auto* gvp = static_cast<const __nv_bfloat16*>(gv);
  auto* op = static_cast<__nv_bfloat16*>(o);
  switch (head_dim) {
    case 16:
      ea::swa_fused_fwd_kernel<16><<<grid, block, 0, st>>>(
          qp, kp, vp, gkp, gvp, op, s, sg, window);
      break;
    case 32:
      ea::swa_fused_fwd_kernel<32><<<grid, block, 0, st>>>(
          qp, kp, vp, gkp, gvp, op, s, sg, window);
      break;
    case 64:
      ea::swa_fused_fwd_kernel<64><<<grid, block, 0, st>>>(
          qp, kp, vp, gkp, gvp, op, s, sg, window);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
