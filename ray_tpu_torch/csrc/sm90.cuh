// Hopper (sm_90a) building blocks for the port's kernels, plain CUDA and
// inline PTX (no CUTLASS, no PyTorch headers):
//   - cp.async copies global -> shared, 16 or 4 bytes, zero-filling what
//     lies past the source's valid bytes, and waits on their groups;
//   - the 128-byte-swizzled layout of a [ROWS x COLS] bf16 tile that wgmma
//     reads, COLS 64 or 128: COLS / 64 panels of 64 columns, each ROWS rows
//     of 128 bytes (one swizzle atom a row), the 16-byte chunk c of row r
//     stored at chunk c ^ (r % 8) (the layout TMA writes under
//     CU_TENSOR_MAP_SWIZZLE_128B); every tile starts on a 1024-byte
//     boundary;
//   - wgmma shared-memory descriptors for that layout, read K-major (the
//     COLS columns are the reduction) or MN-major (the ROWS rows are);
//   - the bf16 wgmma shapes with f32 accumulators that the kernels use;
//   - a host helper that raises a kernel's shared-memory limit once per
//     device.
//
// Accumulator layout of wgmma m64nNk16 (f32), thread t of the warpgroup,
// warp w = t / 32, lane l = t % 32: d[4j + 2i + c] holds row
// 16w + l/4 + 8i, column 8j + 2(l%4) + c. For bf16 this is also the layout
// of the A operand from registers, 16 columns (one k16 step) per 4 words:
// a[kk][0..3] = bf16x2 of d[8kk + 0,1], d[8kk + 2,3], d[8kk + 4,5],
// d[8kk + 6,7]. So a product's accumulator feeds the next product as its A
// without passing through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared address dst; with src_bytes = 0 nothing is
// read and the 16 bytes are zero
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes, likewise
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait until at most N committed cp.async groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// shared-memory writes of the generic proxy (cp.async, st.shared) made
// visible to wgmma, which reads through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// byte offset of 16-byte chunk c (0..15) of row r in a swizzled
// [ROWS x 128] bf16 tile; chunks 0..7 are also the whole row of a
// [ROWS x 64] tile, which is one panel
template <int ROWS>
__device__ __forceinline__ uint32_t sw128_offset(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// rows [r0, r0 + ROWS) of a bf16 matrix with COLS columns (64 or 128; row
// stride in elements, 16-byte aligned) into the swizzled tile at dst, by
// NT threads, this one thread t of them; rows at or past n are zero
template <int ROWS, int NT, int COLS = 128>
__device__ __forceinline__ void load_tile_sw128(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                int r0, int n,
                                                long long row_stride, int t) {
  static_assert(COLS == 64 || COLS == 128, "one or two 64-column panels");
  constexpr int CHUNKS = COLS / 8;   // 16-byte chunks a row
  static_assert((ROWS * CHUNKS) % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * CHUNKS / NT; ++i) {
    // unsigned: the division and remainder are a shift and a mask
    const unsigned idx = t + i * NT;
    const int r = idx / CHUNKS, c = idx % CHUNKS;
    const bool in = r0 + r < n;
    const __nv_bfloat16* p =
        in ? src + (long long)(r0 + r) * row_stride + c * 8 : src;
    cp_async_16(dst + sw128_offset<ROWS>(r, c), p, in ? 16 : 0);
  }
}

// wgmma matrix descriptor, 128-byte swizzle. K-major: lbo is unused (16),
// sbo = 1024, the stride between groups of 8 rows. MN-major: lbo = the
// stride between the 64-column panels, sbo = 1024, the stride between
// groups of 8 rows of the reduction. An MN-major B of N = 64 columns is one
// panel, so no product reads its lbo: the kernels pass 16, as for K-major
// (the card test of sm90_probe.cu checks that another lbo gives the same
// bits, and that a wrong sbo does not).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of these registers across
// a wgmma wait, and from reusing them while a wgmma still reads them
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// two floats as bf16x2 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// an accumulator [64 x 16N] rounded to bf16 as the A operand of N k16 steps
template <int N>
__device__ __forceinline__ void to_a_operand(const float (&d)[8 * N],
                                             uint32_t (&a)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w)
      a[kk][w] = pack_bf16(d[8 * kk + 2 * w], d[8 * kk + 2 * w + 1]);
}

// the four lanes of a quad hold one accumulator row between them
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// D[64 x 64] (+)= A B, A and B read from shared memory through their
// descriptors, both K-major
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D[64 x 64] += A B, A (bf16) from registers in the accumulator layout,
// B read from shared memory MN-major (transposed), one 64-column panel
__device__ __forceinline__ void wgmma_m64n64k16_rs_bt(float (&d)[32],
                                                    const uint32_t (&a)[4],
                                                    uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A B, A (bf16) from registers in the accumulator layout,
// B read from shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_m64n128k16_rs_bt(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x N] += A B at N = 64 or 128, by the accumulator's size: the head
// dim of the kernels' P V, P^T dO and dS^T Q products
__device__ __forceinline__ void wgmma_rs_bt(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  wgmma_m64n64k16_rs_bt(d, a, b);
}

__device__ __forceinline__ void wgmma_rs_bt(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  wgmma_m64n128k16_rs_bt(d, a, b);
}

// Raise Kern's dynamic shared-memory limit to smem bytes once per device
// (a static of this instantiation), not on every launch; the first call's
// result is returned on every later one. Two threads racing here both set
// the same value.
template <auto Kern>
cudaError_t smem_limit_once(int smem) {
  constexpr int MAX_DEVICES = 64;
  static cudaError_t attrs[MAX_DEVICES];
  static bool done[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    attrs[dev] = cudaFuncSetAttribute(
        Kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    done[dev] = true;
  }
  return attrs[dev];
}

}  // namespace sm90
