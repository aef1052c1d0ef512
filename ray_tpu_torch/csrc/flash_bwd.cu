// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, dQ and dK/dV, that rebuild the softmax from the forward's LSE.
//
// Replaces: ray_tpu/ops/attention.py `_flash_bwd_dq_kernel` and
// `_flash_bwd_dkv_kernel`, launched by `flash_attention_tpu_bwd` (the
// Pallas TPU kernels behind the custom VJP of `attention`, once per layer
// per training step).
//
// What they compute (the Pallas semantics, with two deliberate changes):
//   P  = exp(scale * Q K^T - lse)      (rebuilt from the saved LSE)
//   dP = dO V^T,  dS = P * (dP - Dvec), Dvec = rowsum(dO * O) (f32, given)
//   dQ = scale * dS K                  dS rounded to k's dtype first
//   dV = P^T dO                        P rounded to dO's dtype first
//   dK = scale * dS^T Q                dS rounded to q's dtype first
// with the causal mask bottom-right aligned (key j visible to query i when
// j <= i + Skv - Sq). Changes: (1) masked entries of P are selected to
// exactly 0; the Pallas kernel computes exp(-1e30 - lse), which is 1 on a
// row that sees no key (its lse is -1e30), so such rows (causal, Sq > Skv)
// give dQ = 0 and add nothing to dK, dV here; (2) dK and dV are summed over
// the GQA group in f32 inside the kernel and rounded once, where the
// reference rounds each q head's sum before adding the group up.
//
// What bounds them on the H100: at the Llama-3-8B training shape (B=1,
// S=2048, 32 q / 8 kv heads, D=128, causal) dQ does 3 causal products
// (51.5 GFLOP) and dK/dV 4 (68.7 GFLOP) on ~60 MB, so on tensor cores both
// would be bound by operations at ~0.05-0.07 ms. This first version, like
// flash_fwd.cu, does the products with f32 FMAs out of shared memory (no
// wgmma, no TMA): one code path for bf16 and f32 (f32 is held at 1e-4),
// any Sq and Skv (ragged tiles masked), head_dim 64 and 128, inputs read
// through their strides. It is bound by the f32 FMA rate and shared-memory
// bandwidth, far from the tensor-core bound; the wgmma/TMA version is work
// for a later PR.
//
// Design. dQ: one CTA of 256 threads per (64-row q tile, b * Hq), looping
// over the 64-row kv tiles up to the causal diagonal (the mirror of
// flash_fwd's grid). Each thread owns a 4x4 block of S and dP (both built
// in one pass over D) and a 4 x D/16 block of dQ, accumulated in f32.
// dK/dV: one CTA per (64-row kv tile, b * Hkv), looping over the n_rep q
// heads of its GQA group and, for each, over the q tiles from the first one
// that sees the tile; each thread owns 4 x D/16 blocks of dK and dV. Tiles
// are staged in shared memory as f32 with rows padded by one word, so the
// strided reads of the S/dP loop hit distinct banks. Rows and keys past the
// sequence ends load as zero and are masked by select.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// x rounded to T and back (the reference's .astype before a product)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Strides in elements, (batch, seq, head) of q, k, v and dO.
struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

// rows [r0, r0 + R) of one head of x into smem[R][D + 1] as f32, zero past n
template <typename T, int R, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, long long row_stride) {
  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int g = r0 + r;
    dst[r * (D + 1) + d] = g < n ? to_f(src[(long long)g * row_stride + d]) : 0.f;
  }
}

// s[i][j] = A[ty+16i] . B[tx+16j] and dp[i][j] = C[ty+16i] . E[tx+16j]
// over D, all four tiles [64][D + 1] in shared memory
template <int D>
__device__ __forceinline__ void two_products(const float* A, const float* B,
                                             const float* C, const float* E,
                                             float (&s)[4][4],
                                             float (&dp)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; ++d) {
    float a[4], b[4], c[4], e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = A[(ty + 16 * i) * (D + 1) + d];
      c[i] = C[(ty + 16 * i) * (D + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = B[(tx + 16 * j) * (D + 1) + d];
      e[j] = E[(tx + 16 * j) * (D + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(c[i], e[j], dp[i][j]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, T* __restrict__ dq, int Sq, int Skv,
    int Hq, int Hkv, Strides st, float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D + 1]
  float* dOs = Qs + BQ * (D + 1);      // [BQ][D + 1]
  float* Ks = dOs + BQ * (D + 1);      // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);       // [BK][D + 1]
  float* dSs = Vs + BK * (D + 1);      // [BQ][BK + 1], dS in k's dtype
  float* lse_s = dSs + BQ * (BK + 1);  // [BQ]
  float* dvec_s = lse_s + BQ;          // [BQ]

  constexpr int DJ = D / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int q_off = Skv - Sq;

  const T* kb = k + b * st.k_b + hk * st.k_h;
  const T* vb = v + b * st.v_b + hk * st.v_h;
  load_tile<T, BQ, D>(Qs, q + b * st.q_b + h * st.q_h, q0, Sq, st.q_s);
  load_tile<T, BQ, D>(dOs, dout + b * st.o_b + h * st.o_h, q0, Sq, st.o_s);
  const float* lse_row = lse + (long long)bh * Sq;
  const float* dvec_row = dvec + (long long)bh * Sq;
  for (int r = tid; r < BQ; r += NT) {
    const bool in = q0 + r < Sq;
    lse_s[r] = in ? lse_row[q0 + r] : 0.f;
    dvec_s[r] = in ? dvec_row[q0 + r] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  int n_tiles = (Skv + BK - 1) / BK;
  if (causal) {
    // the last key any real row of this tile can see
    const int last_key = min(q0 + BQ, Sq) - 1 + q_off;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers of Ks and dSs are done
    load_tile<T, BK, D>(Ks, kb, k0, Skv, st.k_s);
    load_tile<T, BK, D>(Vs, vb, k0, Skv, st.v_s);
    __syncthreads();

    float s[4][4], dp[4][4];
    two_products<D>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qr = q0 + r, kc = k0 + c;
        const bool ok = qr < Sq && kc < Skv && (!causal || kc <= qr + q_off);
        // select, not exp(-1e30 - lse): a row with no key has lse -1e30
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dSs[r * (BK + 1) + c] = round_to<T>(p * (dp[i][j] - dvec_s[r]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = Ks[kk * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds, kv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= Sq) continue;
    T* row = dq + (((long long)b * Sq + qr) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f<T>(acc[i][j] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv,
    int Sq, int Skv, int Hq, int Hkv, Strides st, float scale, int causal) {
  extern __shared__ float smem[];
  float* Ks = smem;                    // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);       // [BK][D + 1]
  float* Qs = Vs + BK * (D + 1);       // [BQ][D + 1]
  float* dOs = Qs + BQ * (D + 1);      // [BQ][D + 1]
  float* Ps = dOs + BQ * (D + 1);      // [BQ][BK + 1], P in dO's dtype
  float* dSs = Ps + BQ * (BK + 1);     // [BQ][BK + 1], dS in q's dtype
  float* lse_s = dSs + BQ * (BK + 1);  // [BQ]
  float* dvec_s = lse_s + BQ;          // [BQ]

  constexpr int DJ = D / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int n_rep = Hq / Hkv;
  const int k0 = blockIdx.x * BK;
  const int q_off = Skv - Sq;

  load_tile<T, BK, D>(Ks, k + b * st.k_b + hk * st.k_h, k0, Skv, st.k_s);
  load_tile<T, BK, D>(Vs, v + b * st.v_b + hk * st.v_h, k0, Skv, st.v_s);

  // rows kv = ty + 16 i, columns d = tx + 16 j
  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // the first q row that sees key k0 under the causal mask, and its tile
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int first_row = causal ? k0 - q_off : 0;
  const int t0 = first_row <= 0 ? 0 : first_row / BQ;

  for (int rep = 0; rep < n_rep; ++rep) {
    const int h = hk * n_rep + rep;
    const int bh = b * Hq + h;
    const T* qb = q + b * st.q_b + h * st.q_h;
    const T* ob = dout + b * st.o_b + h * st.o_h;
    for (int t = t0; t < n_qt; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, BQ, D>(Qs, qb, q0, Sq, st.q_s);
      load_tile<T, BQ, D>(dOs, ob, q0, Sq, st.o_s);
      for (int r = tid; r < BQ; r += NT) {
        const bool in = q0 + r < Sq;
        lse_s[r] = in ? lse[(long long)bh * Sq + q0 + r] : 0.f;
        dvec_s[r] = in ? dvec[(long long)bh * Sq + q0 + r] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      two_products<D>(Qs, Ks, dOs, Vs, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty + 16 * i, c = tx + 16 * j;
          const int qr = q0 + r, kc = k0 + c;
          const bool ok = qr < Sq && kc < Skv && (!causal || kc <= qr + q_off);
          const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
          Ps[r * (BK + 1) + c] = round_to<T>(p);
          dSs[r * (BK + 1) + c] = round_to<T>(p * (dp[i][j] - dvec_s[r]));
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int rr = 0; rr < BQ; ++rr) {
        float o[DJ], qv[DJ];
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          o[j] = dOs[rr * (D + 1) + tx + 16 * j];
          qv[j] = Qs[rr * (D + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = Ps[rr * (BK + 1) + ty + 16 * i];
          const float ds = dSs[rr * (BK + 1) + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            acc_v[i][j] = fmaf(p, o[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(ds, qv[j], acc_k[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kr = k0 + ty + 16 * i;
    if (kr >= Skv) continue;
    const long long off = (((long long)b * Skv + kr) * Hkv + hk) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + tx + 16 * j] = from_f<T>(acc_k[i][j] * scale);
      dv[off + tx + 16 * j] = from_f<T>(acc_v[i][j]);
    }
  }
}

Strides read_strides(const long long* s) {
  return Strides{s[0], s[1], s[2], s[3], s[4],  s[5],
                 s[6], s[7], s[8], s[9], s[10], s[11]};
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* dvec,
                      void* dq, int B, int Sq, int Skv, int Hq, int Hkv,
                      const long long* st, float scale, int causal,
                      cudaStream_t stream) {
  const size_t smem =
      (size_t)(4 * 64 * (D + 1) + BQ * (BK + 1) + 2 * BQ) * sizeof(float);
  auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dvec,
      (T*)dq, Sq, Skv, Hq, Hkv, read_strides(st), scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* dvec,
                       void* dk, void* dv, int B, int Sq, int Skv, int Hq,
                       int Hkv, const long long* st, float scale, int causal,
                       cudaStream_t stream) {
  const size_t smem =
      (size_t)(4 * 64 * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ) * sizeof(float);
  auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + BK - 1) / BK, B * Hkv);
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dvec,
      (T*)dk, (T*)dv, Sq, Skv, Hq, Hkv, read_strides(st), scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dO and the outputs alike).
// strides: q, k, v, dO (batch, seq, head) in elements; the head_dim stride
// must be 1. lse and dvec are f32 [B, Hq, Sq], contiguous. dQ is written
// [B, Sq, Hq, D] contiguous. Returns cudaGetLastError().
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* dvec, void* dq, int B, int Sq,
                            int Skv, int Hq, int Hkv, int D,
                            const long long* strides, float scale, int causal,
                            int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dv = (const float*)dvec;
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64>(q, k, v, dout, l, dv, dq, B, Sq, Skv, Hq, Hkv,
                                strides, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(q, k, v, dout, l, dv, dq, B, Sq, Skv, Hq,
                                 Hkv, strides, scale, causal, s);
  if (dtype == 1 && D == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, l, dv, dq, B, Sq, Skv,
                                        Hq, Hkv, strides, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, l, dv, dq, B, Sq, Skv,
                                         Hq, Hkv, strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq; dK and dV are written [B, Skv, Hkv, D] contiguous, each
// the sum over its kv head's GQA group.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* dvec, void* dk, void* dv, int B,
                             int Sq, int Skv, int Hq, int Hkv, int D,
                             const long long* strides, float scale,
                             int causal, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  const float* dvc = (const float*)dvec;
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, dout, l, dvc, dk, dv, B, Sq, Skv,
                                 Hq, Hkv, strides, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, dout, l, dvc, dk, dv, B, Sq, Skv,
                                  Hq, Hkv, strides, scale, causal, s);
  if (dtype == 1 && D == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, l, dvc, dk, dv, B, Sq,
                                         Skv, Hq, Hkv, strides, scale, causal,
                                         s);
  if (dtype == 1 && D == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, l, dvc, dk, dv, B,
                                          Sq, Skv, Hq, Hkv, strides, scale,
                                          causal, s);
  return (int)cudaErrorInvalidValue;
}
