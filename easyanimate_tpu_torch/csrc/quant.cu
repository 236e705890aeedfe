// Q1, Q2, Q3: the passes around the quantized block linears' products
// (easyanimate_tpu_torch/ops/quant.py; the JAX package's ops/quant.py).
//
// They replace no TPU kernel: the JAX package leaves these passes to XLA,
// which fuses them into the int8 dot on the TPU. Written as plain PyTorch,
// each of them is several float32 round trips through device memory (the
// absmax, the scaled copy, the rounding, the cast; or the int32 -> float32
// copy, two scalings, the bias add, the cast), and at the 12B's shapes
// (26,208 video tokens a CFG pair, widths 3,072 and 12,288) those cost
// more than the int8 product saves over bf16. Each kernel here reads its
// inputs once and writes its outputs once.
//
// Every pass must give the plain version's bits (Q1's int8 values feed an
// exact integer product; Q2 and Q3 are held to them on the card), so the
// float32 arithmetic is spelled with the round-to-nearest intrinsics:
// __fdiv_rn (IEEE division, as XLA's and PyTorch's), __fmul_rn and
// __fadd_rn (never contracted into an FMA, which nvcc does by default with
// * and +), __float2int_rn (half to even, as torch.round and jnp.round),
// __float2bfloat16_rn (the cast PyTorch makes).
//
// All three are bound by bytes on the H100 (3.35 TB/s): they do a few
// operations per element.
//   Q1 quantize_rows: bf16 [M, K] in, int8 [M, K] + float32 [M] out; one
//      block of 128 threads per row, 16-byte loads; the absmax pass and the
//      quantize pass both read the row (the second from L2).
//   Q2 dequantize_rows: int32 [M, N] + float32 ax [M], w_scale [N], bias [N]
//      in, bf16 [M, N] out; one block of 256 threads per row, 4 columns a
//      thread a step (16-byte loads, 8-byte stores).
//   Q3 unpack_int4: packed int8 [N, K/2] + float32 scale [N, groups] in;
//      bf16 [N, K] out (W4A16), or int8 [N, K] + float32 s8 [N] (the W4A8
//      regrid onto one per-channel grid); one block of 128 threads per
//      output row, 16 packed bytes (32 in-features, inside one group) a
//      thread a step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ea {
namespace quant {

constexpr int kQ1Threads = 128;
constexpr int kQ2Threads = 256;
constexpr int kQ3Threads = 128;

// max over the block (blockDim.x a multiple of 32, at most 1024 threads)
__device__ float block_max(float v) {
  __shared__ float warp_max[32];
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x / 32;
  v = lane < n_warps ? warp_max[lane] : 0.0f;
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;  // every thread holds the block's max (inputs are >= 0)
}

__device__ __forceinline__ int8_t q1_round(float x, float r) {
  return static_cast<int8_t>(__float2int_rn(__fmul_rn(x, r)));
}

// Q1: xq = round(x * (127 / ax)), ax = max(max_k |x|, 1e-12)
__global__ void __launch_bounds__(kQ1Threads)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ x,
                     int8_t* __restrict__ xq, float* __restrict__ ax, int k) {
  const int64_t row = blockIdx.x;
  const uint4* src = reinterpret_cast<const uint4*>(x + row * k);
  const int n_vec = k / 8;
  float m = 0.0f;
  for (int i = threadIdx.x; i < n_vec; i += kQ1Threads) {
    uint4 v = src[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  const float a = fmaxf(block_max(m), 1e-12f);
  const float r = __fdiv_rn(127.0f, a);
  if (threadIdx.x == 0) ax[row] = a;
  uint2* dst = reinterpret_cast<uint2*>(xq + row * k);
  for (int i = threadIdx.x; i < n_vec; i += kQ1Threads) {
    uint4 v = src[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    alignas(8) int8_t q[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      q[2 * j] = q1_round(f.x, r);
      q[2 * j + 1] = q1_round(f.y, r);
    }
    dst[i] = *reinterpret_cast<const uint2*>(q);
  }
}

// Q2: y = float(acc) * (ax / 127) * w_scale (+ bias), in that order
__global__ void __launch_bounds__(kQ2Threads)
dequantize_rows_kernel(const int32_t* __restrict__ acc,
                       const float* __restrict__ ax,
                       const float* __restrict__ w_scale,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, int n) {
  const int64_t row = blockIdx.x;
  const float rs = __fdiv_rn(ax[row], 127.0f);
  const int4* src = reinterpret_cast<const int4*>(acc + row * n);
  const float4* ws = reinterpret_cast<const float4*>(w_scale);
  const float4* bs = reinterpret_cast<const float4*>(bias);
  uint2* dst = reinterpret_cast<uint2*>(y + row * n);
  for (int i = threadIdx.x; i < n / 4; i += kQ2Threads) {
    const int4 a = src[i];
    const float4 w = ws[i];
    float o[4] = {__fmul_rn(__fmul_rn(__int2float_rn(a.x), rs), w.x),
                  __fmul_rn(__fmul_rn(__int2float_rn(a.y), rs), w.y),
                  __fmul_rn(__fmul_rn(__int2float_rn(a.z), rs), w.z),
                  __fmul_rn(__fmul_rn(__int2float_rn(a.w), rs), w.w)};
    if (bias != nullptr) {
      const float4 b = bs[i];
      o[0] = __fadd_rn(o[0], b.x);
      o[1] = __fadd_rn(o[1], b.y);
      o[2] = __fadd_rn(o[2], b.z);
      o[3] = __fadd_rn(o[3], b.w);
    }
    alignas(8) __nv_bfloat162 out[2] = {__floats2bfloat162_rn(o[0], o[1]),
                                        __floats2bfloat162_rn(o[2], o[3])};
    dst[i] = *reinterpret_cast<const uint2*>(out);
  }
}

// the two int4 values of a packed byte, sign-extended by arithmetic shifts
__device__ __forceinline__ int low_nibble(int8_t b) {
  return static_cast<int8_t>(static_cast<uint8_t>(b) << 4) >> 4;
}
__device__ __forceinline__ int high_nibble(int8_t b) { return b >> 4; }

// Q3: byte b of a packed row holds in-features 2b (low nibble) and 2b + 1
// (high nibble), each sign-extended by arithmetic shifts. W4A16 writes
// q4 * s_g in bf16; the W4A8 regrid writes q8 = round(q4 * (s_g / s8)),
// s8 = max(max_g s_g, 1e-12) * 8/127.
__global__ void __launch_bounds__(kQ3Threads)
unpack_int4_kernel(const int8_t* __restrict__ packed,
                   const float* __restrict__ scale, void* __restrict__ w,
                   float* __restrict__ s8_out, int k, int groups,
                   int to_int8) {
  const int64_t row = blockIdx.x;
  const float* s = scale + row * groups;
  const int group_bytes = k / groups / 2;
  float s8 = 0.0f;
  if (to_int8) {
    float m = 0.0f;
    for (int g = threadIdx.x; g < groups; g += kQ3Threads) m = fmaxf(m, s[g]);
    s8 = __fmul_rn(fmaxf(block_max(m), 1e-12f),
                   static_cast<float>(8.0 / 127.0));
    if (threadIdx.x == 0) s8_out[row] = s8;
  }
  const uint4* src = reinterpret_cast<const uint4*>(packed + row * (k / 2));
  for (int i = threadIdx.x; i < k / 32; i += kQ3Threads) {
    uint4 v = src[i];
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
    const float sg = s[(16 * i) / group_bytes];
    if (to_int8) {
      const float ratio = __fdiv_rn(sg, s8);
      alignas(16) int8_t q[32];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int lo = low_nibble(b[j]), hi = high_nibble(b[j]);
        q[2 * j] = static_cast<int8_t>(
            __float2int_rn(__fmul_rn(static_cast<float>(lo), ratio)));
        q[2 * j + 1] = static_cast<int8_t>(
            __float2int_rn(__fmul_rn(static_cast<float>(hi), ratio)));
      }
      uint4* dst = reinterpret_cast<uint4*>(static_cast<int8_t*>(w) + row * k);
      dst[2 * i] = reinterpret_cast<const uint4*>(q)[0];
      dst[2 * i + 1] = reinterpret_cast<const uint4*>(q)[1];
    } else {
      alignas(16) __nv_bfloat162 o[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int lo = low_nibble(b[j]), hi = high_nibble(b[j]);
        o[j] = __floats2bfloat162_rn(__fmul_rn(static_cast<float>(lo), sg),
                                     __fmul_rn(static_cast<float>(hi), sg));
      }
      uint4* dst = reinterpret_cast<uint4*>(
          static_cast<__nv_bfloat16*>(w) + row * k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dst[4 * i + j] = reinterpret_cast<const uint4*>(o)[j];
      }
    }
  }
}

}  // namespace quant
}  // namespace ea

extern "C" int ea_quantize_rows_bf16(const void* x, void* xq, void* ax, int m,
                                     int k, void* stream) {
  if (m == 0) return 0;
  ea::quant::quantize_rows_kernel<<<m, ea::quant::kQ1Threads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq),
      static_cast<float*>(ax), k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ea_dequantize_rows_bf16(const void* acc, const void* ax,
                                       const void* w_scale, const void* bias,
                                       void* y, int m, int n, void* stream) {
  if (m == 0) return 0;
  ea::quant::dequantize_rows_kernel<<<m, ea::quant::kQ2Threads, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(acc), static_cast<const float*>(ax),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ea_unpack_int4(const void* packed, const void* scale, void* w,
                              void* s8, int n, int k, int groups, int to_int8,
                              void* stream) {
  if (n == 0) return 0;
  ea::quant::unpack_int4_kernel<<<n, ea::quant::kQ3Threads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(packed), static_cast<const float*>(scale), w,
      static_cast<float*>(s8), k, groups, to_int8);
  return static_cast<int>(cudaGetLastError());
}
