// A probe of the csrc/sm90.cuh pieces that the tensor-core flash kernels
// use at head_dim 64, for test_torch_cuda.py: one warpgroup loads two
// [64 x 64] bf16 matrices with load_tile_sw128<64, 128, 64> (one
// 128-byte swizzle atom a row) and multiplies them on wgmma.
//
//   mode 0: D = A B^T, both read K-major from shared memory
//           (wgmma_m64n64k16_ss, as Q K^T);
//   mode 1: D = A B, A from registers in the accumulator layout and B
//           (K x N) read MN-major (wgmma_m64n64k16_rs_bt, as P V).
//
// lbo and sbo are the descriptors' byte offsets; swizzle = 0 writes the
// tiles unswizzled. Both are there so that a test can run controls that
// must fail. Build: nvcc <the port's flags> -I ray_tpu_torch/csrc.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int N = 64;
constexpr int TILE = N * N * 2;

__global__ void __launch_bounds__(128, 1) sm90_probe_kernel(
    const __nv_bfloat16* a, const __nv_bfloat16* b, float* d, int mode,
    int lbo, int sbo, int swizzle) {
  __shared__ uint8_t smem_raw[2 * TILE + 1024];
  const uint32_t sa = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sb = sa + TILE;
  const int t = threadIdx.x;
  if (swizzle) {
    load_tile_sw128<N, 128, N>(sa, a, 0, N, N, t);
    load_tile_sw128<N, 128, N>(sb, b, 0, N, N, t);
  } else {
    for (int idx = t; idx < N * 8; idx += 128) {
      const int r = idx / 8, c = idx % 8;
      cp_async_16(sa + r * 128 + c * 16, a + r * N + c * 8, 16);
      cp_async_16(sb + r * 128 + c * 16, b + r * N + c * 8, 16);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  const int warp = t / 32, lane = t % 32;
  const int row0 = 16 * warp + lane / 4, col0 = 2 * (lane % 4);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  // A in the accumulator layout: a[kk][w] holds row row0 + 8 (w % 2),
  // columns 16 kk + 8 (w / 2) + col0 + {0, 1}
  uint32_t ra[4][4];
  const uint16_t* a16 = reinterpret_cast<const uint16_t*>(a);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int i = (row0 + 8 * (w % 2)) * N + 16 * kk + 8 * (w / 2) + col0;
      ra[kk][w] = (uint32_t)a16[i] | ((uint32_t)a16[i + 1] << 16);
    }
  wgmma_fence();
  if (mode == 0) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_ss(acc, desc_sw128(sa + kk * 32, lbo, sbo),
                         desc_sw128(sb + kk * 32, lbo, sbo), kk);
  } else {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n64k16_rs_bt(acc, ra[kk],
                            desc_sw128(sb + kk * 16 * 128, lbo, sbo));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(ra);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        d[(row0 + 8 * i) * N + 8 * j + col0 + c] = acc[4 * j + 2 * i + c];
}

}  // namespace

// a, b: [64 x 64] bf16 row-major, 16-byte aligned; d: [64 x 64] f32.
// Returns cudaGetLastError().
extern "C" int sm90_probe(const void* a, const void* b, void* d, int mode,
                          int lbo, int sbo, int swizzle, void* stream) {
  sm90_probe_kernel<<<1, 128, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (float*)d, mode, lbo,
      sbo, swizzle);
  return (int)cudaGetLastError();
}
