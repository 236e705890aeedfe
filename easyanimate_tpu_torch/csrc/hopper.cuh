// Hopper (sm_90a) building blocks for the port's TMA + wgmma kernels.
//
// Users: K1, K2 and K5, the dense, the sliding-window and the fused
// sliding-window + global forward (flash_fwd.cu, swa_fwd.cu and
// swa_fused_fwd.cu on fwd_sm90.cuh), and K3/K4 and K6/K7, the dense and the
// sliding-window backward's dq and dk/dv kernels (flash_bwd.cu and
// swa_bwd.cu on bwd_sm90.cuh), all at head_dim 64, and K1 at head_dim 88
// and 72 (flash_fwd.cu on fwd_split_sm90.cuh), all bound by operations at
// the flagship shapes ([96, 13360, 64] bf16; the banded ones [96, 13104,
// 64] banded to 1,008; V4's [32, 36864, 88]; V3's [32, 36864, 72]); and
// K1's short-head kernel at d 72 and 144 (flash_fwd.cu on
// fwd_short_sm90.cuh), bound by bytes (heads of 36 or 64 rows).
// Their common shape: one producer warpgroup keeps TMA loads in flight
// through a ring of shared-memory stages guarded by full/empty mbarriers,
// and consumer warpgroups run the products on the tensor cores with wgmma
// (score-like products with both operands in shared memory, products with
// a probability-like operand from registers).
//
// Conventions the pieces rely on:
//   - Tiles are bf16 rows of 64 elements (128 bytes), loaded by TMA with
//     CU_TENSOR_MAP_SWIZZLE_128B into shared memory that starts 1024-byte
//     aligned: 8 rows form one 1024-byte swizzle atom. At d 88 a row is
//     two such tiles: columns 0-63 as above and columns 64-95 as rows of
//     64 bytes with CU_TENSOR_MAP_SWIZZLE_64B (desc_sw64), 8 rows a
//     512-byte atom; at d 72 the second is columns 64-79, rows of 32
//     bytes with CU_TENSOR_MAP_SWIZZLE_32B (desc_sw32), 8 rows 256 bytes.
//   - A "K-major" operand (q or k: the reduction dimension d is contiguous)
//     and an "MN-major" one (v in p v: the output dimension d is contiguous)
//     both use desc_sw128 with a stride of 1024 bytes between 8-row groups.
//     A 16-deep k step advances a K-major descriptor by 32 bytes (+2 in the
//     address field) and an MN-major one by 16 rows (2048 bytes).
//   - The f32 accumulator of an m64nN wgmma: warp w of the warpgroup holds
//     rows 16w + g and 16w + g + 8 (g = lane / 4); element 4i + e is column
//     8i + 2 (lane % 4) + (e & 1) of row 16w + g + 8 (e >> 1), i < N / 8 --
//     the mma.sync m16n8 layout repeated over N. The A fragment of a
//     register-sourced wgmma is the mma.sync m16n8k16 A layout of the same
//     rows, so a score accumulator re-packs to bf16x2 as p.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ea {
namespace sm90 {

// Returned by a C entry point when cuTensorMapEncodeTiled fails, plus the
// CUresult; ops/_build.py names it.
constexpr int kTensorMapError = 10000;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// After the inits, before any other thread uses the barriers.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that can
// never end (a wrong parity) traps after 2^24 tries instead of hanging the
// card. The trap comes after the launch has returned, so the wrapper does
// not see it: it shows as a sticky cudaErrorLaunchFailure at the next
// synchronising call, and the process must restart to use the card again.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

// ---- TMA ----------------------------------------------------------------

// Load the box at coordinates (c0, c1, c2) of `map` into shared memory;
// completion adds the box's bytes to `bar`'s transaction count. Elements
// outside the tensor's extent arrive as zeros.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Store a shared-memory box to (c0, c1, c2) of `map`; rows outside the
// tensor's extent are not written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// Commit the issued TMA stores and wait until their shared-memory source
// has been read.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Make this thread's shared-memory writes visible to the async proxy (a
// TMA store or a wgmma that reads them).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma --------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address >> 4 in
// bits 0-13, leading byte offset >> 4 in 16-29, stride byte offset >> 4 in
// 32-45, layout 1 (128B swizzle) in 62-63.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// The same, 64-byte swizzle (layout 2): rows of 32 bf16, 8 rows a 512-byte
// atom, so the stride between 8-row groups of a dense tile is 512 bytes.
// A 16-deep k step advances a K-major descriptor by 32 bytes, as at 128.
__device__ __forceinline__ uint64_t desc_sw64(const void* tile,
                                              uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(2) << 62;
  return d;
}

// The same, 32-byte swizzle (layout 3): rows of 16 bf16, 8 rows a 256-byte
// atom. A 16-deep k step is one whole row.
__device__ __forceinline__ uint64_t desc_sw32(const void* tile,
                                              uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  uint64_t d = (smem_u32(tile) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(3) << 62;
  return d;
}

// Before a wgmma that reads registers or shared memory written since the
// last one (the rescaled accumulator, p).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator or of a
// register A operand across a wgmma that is still in flight, or writes of
// them past the wgmma_fence meant to order them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

// d[64x128] (+)= A[64x16] B[16x128], both from shared memory, both K-major
// (bf16 in, f32 accumulate); scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t desc_a,
                                                    uint64_t desc_b,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64x64] (+)= A[64x16] B[16x64], both from shared memory, both K-major.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64x64] (+)= A[64x16] B[16x64]: A from registers (the mma.sync A
// fragment, 4 x bf16x2), B from shared memory MN-major (transposed: its
// output dimension is contiguous); scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d[64x96] (+)= A[64x16] B[16x96], both from shared memory, both K-major
// (K1's scores at head dim 88: a kv tile of 96 rows).
__device__ __forceinline__ void wgmma_m64n96k16_ss(float (&d)[48],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[64x16] (+)= A[64x16] B[16x16]: A from registers, B from shared memory
// MN-major, as wgmma_m64n64k16_rs_tb (K1's p v over head-dim columns
// 128-143 at d 144).
__device__ __forceinline__ void wgmma_m64n16k16_rs_tb(float (&d)[8],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d[64x24] (+)= A[64x16] B[16x24]: A from registers, B from shared memory
// MN-major, as wgmma_m64n64k16_rs_tb (K1's p v over head-dim columns 64-87
// at d 88).
__device__ __forceinline__ void wgmma_m64n24k16_rs_tb(float (&d)[12],
                                                      const uint32_t (&a)[4],
                                                      uint64_t desc_b,
                                                      int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// d[64x8] (+)= A[64x16] B[16x8]: A from registers, B from shared memory
// MN-major, as wgmma_m64n64k16_rs_tb (K1's p v over head-dim columns 64-71
// at d 72).
__device__ __forceinline__ void wgmma_m64n8k16_rs_tb(float (&d)[4],
                                                     const uint32_t (&a)[4],
                                                     uint64_t desc_b,
                                                     int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// 2^x on the MUFU unit (about 2 ulp; exp2(-inf) = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- warp specialisation ------------------------------------------------

// Give the warpgroup N registers per thread (a consumer) / take it down to
// N (the producer). Every thread of the warpgroup executes it, in a branch
// that never rejoins the other roles.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// setmaxnreg.inc waits for registers the producer gives back, so a kernel
// launched with other than the `regs` a thread its setmaxnreg balance
// assumes may never finish. Returns 0 if ptxas gave the kernel `regs`, else
// cudaErrorInvalidConfiguration (or the query's error): the caller then
// refuses the launch.
template <typename Kernel>
int check_launch_regs(Kernel* kernel, int regs) {
  cudaFuncAttributes attr;
  const cudaError_t st = cudaFuncGetAttributes(&attr, kernel);
  if (st != cudaSuccess) return static_cast<int>(st);
  return attr.numRegs == regs
             ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// ---- host: tensor maps --------------------------------------------------

// cuTensorMapEncodeTiled lives in the driver (libcuda); it is fetched
// through the runtime, so the library links against nothing more.
using EncodeTiledFn = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return static_cast<EncodeTiledFn>(nullptr);
    }
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// A 3-D map (d, rows, heads) over bf16 [heads, *, d] rows of `cols`
// elements, head `h` starting head_stride_bytes * h after `base`; boxes of
// box_rows x box_cols, `swizzle` (box_cols * 2 bytes at most its span).
// Columns at or past `cols` and rows at or past `rows` read as zeros and
// are not written. Returns 0, or kTensorMapError + the CUresult.
inline int encode_rows(CUtensorMap* map, const void* base, int cols,
                       int rows, int heads, uint64_t head_stride_bytes,
                       int box_cols, int box_rows,
                       CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {cols * sizeof(__nv_bfloat16),
                                 head_stride_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

// Rows of d = 64 (128 bytes) in boxes of box_rows x 64, 128-byte swizzle.
inline int encode_rows_sw128(CUtensorMap* map, const void* base, int rows,
                             int heads, uint64_t head_stride_bytes,
                             int box_rows) {
  return encode_rows(map, base, 64, rows, heads, head_stride_bytes, 64,
                     box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace sm90
}  // namespace ea
