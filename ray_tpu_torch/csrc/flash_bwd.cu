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
// (51.6 GFLOP) and dK/dV 4 (68.8 GFLOP) on ~60 MB, so on tensor cores both
// are bound by operations, at ~0.05 and ~0.07 ms.
//
// Four kernels:
//
// flash_bwd_dq_tc_kernel<D>: dQ for bf16 with D = 64 or 128 (the training
// paths, CLIP's towers), on the tensor cores (wgmma), the mirror of the
// dK/dV kernel below with the q tile as M. A CTA is one (b, q head) and
// WGS warpgroups on 64 q rows each (DqSmem: two at D = 128, as in
// flash_fwd_tc_kernel; one at D = 64), whose Q and dO tiles
// (128-byte-swizzled) and lse and Dvec (registers) stay for the whole
// kernel; K and V stream through a cp.async double buffer the warpgroups
// share, the next kv tile loading while this one's products run. D sets
// the tiles (one 64-column swizzle panel a row at 64, two at 128), the
// D / 16 k-steps of S and dP, the N of the dQ product, its D / 2
// accumulator registers and the warpgroups a CTA. Per kv tile: S = Q
// K^T and dP = dO V^T (m64n64k16, all operands K-major from shared
// memory), P = exp2(S scale log2e - lse log2e) with masked entries
// selected to exactly 0 (only on the tiles the diagonal or the end of the
// keys cuts) while dP is still running, dS = P (dP - Dvec) in f32, then dQ
// += dS K (m64nDk16) with dS rounded to bf16 as the A operand in registers
// and K read MN-major from the same tile S read K-major. dQ stays in f32
// registers and is scaled and rounded once: no atomics, no scratch,
// deterministic. Causal CTAs launch heaviest q block first. At D = 128
// bound, like the forward, by how much of the tensor cores' time two
// warpgroups keep busy between syncs; at D = 64 (CLIP ViT-B/16: B = 128,
// S = 197, 12 heads, 4 kv tiles a CTA) by the bytes, 196 MB against 23
// GFLOP, and by how many loads the SM keeps in flight.
//
// flash_bwd_dkv_tc_kernel<D>: dK/dV for bf16 with D = 64 or 128 (the
// training paths, CLIP's towers), on the tensor cores (wgmma), the variant
// that landed. D sets the tiles (one 64-column swizzle panel a row at 64,
// two at 128), the D / 16 k-steps of S^T and dP^T, the N of the dV and dK
// products and their D / 2 accumulator registers each. A CTA is two
// warpgroups on one 64-row kv tile; the tile's K and V sit in shared memory
// in the 128-byte-swizzled layout wgmma reads (sm90.cuh). The steps are
// the (q head of the GQA group, 64-row q tile) pairs that see the kv tile;
// each warpgroup takes every other step, with its own cp.async double
// buffer of Q, dO, lse and Dvec (the next step's tiles load while this
// one's products run). A step runs all four products on wgmma, S and dP
// transposed so that the kv rows are M: S^T = K Q^T and dP^T = V dO^T
// (m64n64k16, both operands from shared memory), then dV += P^T dO and
// dK += dS^T Q (m64nDk16) with A from registers: the bf16 rounding of
// the S^T and dP^T accumulators is already the A-operand layout, so P and
// dS never pass through shared memory, and Q and dO are read from the same
// tiles as B, MN-major. The softmax rebuild of one warpgroup overlaps the
// other's products. dK and dV stay in f32 registers over every step (D
// per thread); at the end the second warpgroup's sums go to the first
// through shared memory, in a fixed order, and are rounded once: no
// atomics, no scratch, deterministic. The causal work of kv tile j falls
// with j, so CTA c takes tile c and then tile n_kt - 1 - c: every CTA does
// n_qt + 1 q tiles per head (132 steps at the 8B shape, 128 CTAs on 132
// SMs, one wave). What bounds it now is how much of the tensor cores' time
// two warpgroups keep busy between syncs and softmax, not the bytes.
//
// flash_bwd_dkv_kernel and flash_bwd_dq_kernel (f32 with D = 16, 32, 64
// or 128; bf16 with D = 16 or 32): the first
// version, like flash_fwd.cu's SIMT kernel, with f32 FMAs out of shared
// memory (no wgmma, no TMA), bound by the f32 FMA rate and shared-memory
// bandwidth, far from the tensor-core bound; f32 is held at 1e-4.
// dQ: one CTA of 256 threads per (64-row q tile, b * Hq), looping over the
// 64-row kv tiles up to the causal diagonal (the mirror of flash_fwd's
// grid). Each thread owns a 4x4 block of S and dP (both built in one pass
// over D) and a 4 x D/16 block of dQ, accumulated in f32. dK/dV: one CTA
// per (64-row kv tile, b * Hkv), looping over the n_rep q heads of its GQA
// group and, for each, over the q tiles from the first one that sees the
// tile; each thread owns 4 x D/16 blocks of dK and dV. Tiles are staged in
// shared memory as f32 with rows padded by one word, so the strided reads
// of the S/dP loop hit distinct banks. D maps onto the 16 columns of
// threads as D / 16 values a thread (1 at D = 16, 2 at 32); the S and dP
// blocks do not depend on D, and the shared tiles shrink with it.
//
// All four take any Sq and Skv: rows and keys past the sequence ends load
// as zero and are masked by select.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

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

// At D = 16 and 32 both SIMT kernels declare two CTAs an SM (at most 128
// registers a thread): with no minimum, ptxas aims at 64-80 registers
// there and spills. D = 64 and 128 declare 0, which ptxas reads as no
// minimum (the registers of a build without the argument); a minimum of
// 1 is not the same: it lets ptxas take more registers.
template <int D>
constexpr int min_ctas() { return D <= 32 ? 2 : 0; }

template <typename T, int D>
__global__ void __launch_bounds__(NT, min_ctas<D>()) flash_bwd_dq_kernel(
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
__global__ void __launch_bounds__(NT, min_ctas<D>())
flash_bwd_dkv_kernel(
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

// --- dK/dV on tensor cores: bf16, head_dim 64 or 128 ----------------------

namespace tc {

constexpr int BK = 64;   // kv rows per tile: the M of every product
constexpr int BR = 64;   // q rows per step (32 measured slower)
constexpr int NWG = 2;   // warpgroups, each on every other step (1 slower)
constexpr int NT = 128 * NWG;
constexpr int PANEL = 64 * 128;   // a 64-row tile's 64-column panel, bytes
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the dK/dV kernel, byte offsets from a 1024-byte-aligned
// base: the K and V tiles, then for each warpgroup two buffers each of Q,
// dO, lse and Dvec; every tile 64 rows of D columns. At the end of a kv
// tile the second warpgroup's dK and dV (f32, D a thread) go through the
// Q buffers to the first.
template <int D>
struct DkvSmem {
  static constexpr int KV_TILE = BK * D * 2;
  static constexpr int Q_TILE = BR * D * 2;
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = OFF_K + KV_TILE;
  static constexpr int OFF_Q = OFF_V + KV_TILE;               // [NWG][2]
  static constexpr int OFF_DO = OFF_Q + 2 * NWG * Q_TILE;     // [NWG][2]
  static constexpr int OFF_LSE = OFF_DO + 2 * NWG * Q_TILE;   // [NWG][2][BR]
  static constexpr int OFF_DVEC = OFF_LSE + 2 * NWG * BR * 4; // [NWG][2][BR]
  static constexpr int BYTES = OFF_DVEC + 2 * NWG * BR * 4 + 1024;  // + slack
  static_assert(2 * NWG * Q_TILE >= 128 * D * 4,
                "the Q buffers hold one warpgroup's dK and dV");
};

// wait at barrier 1 + wg for the 128 threads of warpgroup wg
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Skv, int Hq, int Hkv,
    Strides st, float scale, int causal) {
  using namespace sm90;
  static_assert(D == 64 || D == 128, "one or two 64-column panels");
  using S = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int n_rep = Hq / Hkv;
  const int q_off = Skv - Sq;
  const int n_kt = (Skv + BK - 1) / BK, n_qt = (Sq + BR - 1) / BR;
  const float scale_log2 = scale * LOG2E;
  // this thread's accumulator rows (kv) row0 and row0 + 8, and columns
  // 8j + col0 + {0, 1} (q rows in S^T and dP^T, head_dim in dK and dV)
  const int row0 = 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  // the lbo of Q and dO read MN-major: their panel stride at D = 128; one
  // panel at D = 64, where no product reads it (sm90.cuh)
  constexpr uint32_t lbo = D == 128 ? PANEL : 16;

  // CTA c takes kv tile c, then (causal) kv tile n_kt - 1 - c: the two
  // see n_qt + 1 q tiles per head together, so every CTA does the same work
  const int c = blockIdx.x, mirror = n_kt - 1 - c;
  const int n_pass = causal && mirror != c ? 2 : 1;
  for (int pass = 0; pass < n_pass; ++pass) {
    const int k0 = (pass == 0 ? c : mirror) * BK;
    // the steps: for each of the n_rep q heads, the q tiles from the first
    // one that sees key k0; warpgroup wg takes steps wg, wg + NWG, ...
    const int first_row = causal ? k0 - q_off : 0;
    const int t0 = first_row <= 0 ? 0 : first_row / BR;
    const int per_rep = max(n_qt - t0, 0);
    const int n_steps = n_rep * per_rep;
    const int n_mine = max(n_steps - wg + NWG - 1, 0) / NWG;

    // cp.async of this warpgroup's i-th step (Q, dO, lse, Dvec) into its
    // buffer i & 1
    auto load_step = [&](int i) {
      const int s = wg + NWG * i;
      const int h = hk * n_rep + s / per_rep;
      const int q0 = (t0 + s % per_rep) * BR;
      const int buf = wg * 2 + (i & 1);
      load_tile_sw128<BR, 128, D>(base + S::OFF_Q + buf * S::Q_TILE,
                                  q + b * st.q_b + h * st.q_h, q0, Sq,
                                  st.q_s, wt);
      load_tile_sw128<BR, 128, D>(base + S::OFF_DO + buf * S::Q_TILE,
                                  dout + b * st.o_b + h * st.o_h, q0, Sq,
                                  st.o_s, wt);
      if (wt < 2 * BR) {
        const int r = wt % BR;
        const bool in = q0 + r < Sq;
        const float* src = (wt < BR ? lse : dvec) +
                           (long long)(b * Hq + h) * Sq + (in ? q0 + r : 0);
        cp_async_4(
            base + (wt < BR ? S::OFF_LSE : S::OFF_DVEC) + (buf * BR + r) * 4,
            src, in ? 4 : 0);
      }
    };

    __syncthreads();  // the previous pass is done with K, V and the buffers
    load_tile_sw128<BK, NT, D>(base + S::OFF_K, k + b * st.k_b + hk * st.k_h,
                               k0, Skv, st.k_s, tid);
    load_tile_sw128<BK, NT, D>(base + S::OFF_V, v + b * st.v_b + hk * st.v_h,
                               k0, Skv, st.v_s, tid);
    if (n_mine > 0) load_step(0);
    cp_async_commit();
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // K, V and every warpgroup's first step are in

    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    for (int i = 0; i < n_mine; ++i) {
      const int buf = wg * 2 + (i & 1);
      if (i > 0) {
        cp_async_wait_all();
        fence_proxy_async();
        // step i's tiles are in, and the warpgroup is done with step i - 1
        wg_sync(wg);
      }
      if (i + 1 < n_mine) load_step(i + 1);
      cp_async_commit();

      const int q0 = (t0 + (wg + NWG * i) % per_rep) * BR;
      const uint32_t qs = base + S::OFF_Q + buf * S::Q_TILE;
      const uint32_t dos = base + S::OFF_DO + buf * S::Q_TILE;
      const float* lse_s =
          reinterpret_cast<const float*>(sbase + S::OFF_LSE) + buf * BR;
      const float* dvec_s =
          reinterpret_cast<const float*>(sbase + S::OFF_DVEC) + buf * BR;

      // S^T = K Q^T and dP^T = V dO^T, [BK x BR], head_dim in D / 16 k16
      // steps (K-major: the step moves 32 bytes inside a 64-column panel)
      float s_acc[BR / 2], dp_acc[BR / 2];
#pragma unroll
      for (int i = 0; i < BR / 2; ++i) s_acc[i] = dp_acc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks >> 2) * PANEL + (ks & 3) * 32;
        wgmma_m64n64k16_ss(s_acc, desc_sw128(base + S::OFF_K + off, 16, 1024),
                           desc_sw128(qs + off, 16, 1024), ks);
      }
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks >> 2) * PANEL + (ks & 3) * 32;
        wgmma_m64n64k16_ss(dp_acc, desc_sw128(base + S::OFF_V + off, 16, 1024),
                           desc_sw128(dos + off, 16, 1024), ks);
      }
      wgmma_commit();

      // P^T = exp(scale S^T - lse), masked entries selected to exactly 0,
      // while dP^T is still on the tensor cores
      wgmma_wait<1>();
      fence_regs(s_acc);
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int col = 8 * j + col0 + cc;
          const int qr = q0 + col;
          const float l2 = lse_s[col] * LOG2E;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int kr = k0 + row0 + 8 * i;
            const bool ok =
                qr < Sq && kr < Skv && (!causal || kr <= qr + q_off);
            float& x = s_acc[4 * j + 2 * i + cc];
            x = ok ? exp2f(fmaf(x, scale_log2, -l2)) : 0.f;
          }
        }
      }
      // dV += P^T dO: P^T rounded to bf16 (dO's dtype) in registers, dO
      // read MN-major, its q rows the reduction
      uint32_t pa[BR / 16][4];
      to_a_operand(s_acc, pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
        wgmma_rs_bt(acc_v, pa[kk], desc_sw128(dos + kk * 16 * 128, lbo, 1024));
      wgmma_commit();

      // dS^T = P^T * (dP^T - Dvec), with the f32 P, while dV runs
      wgmma_wait<1>();
      fence_regs(dp_acc);
#pragma unroll
      for (int j = 0; j < BR / 8; ++j) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const float dvc = dvec_s[8 * j + col0 + cc];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int idx = 4 * j + 2 * i + cc;
            dp_acc[idx] = s_acc[idx] * (dp_acc[idx] - dvc);
          }
        }
      }
      // dK += dS^T Q: dS^T rounded to bf16 (q's dtype), Q read MN-major
      uint32_t da[BR / 16][4];
      to_a_operand(dp_acc, da);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk)
        wgmma_rs_bt(acc_k, da[kk], desc_sw128(qs + kk * 16 * 128, lbo, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pa);
      fence_regs(da);
      fence_regs(acc_v);
      fence_regs(acc_k);
    }

    // the second warpgroup's sums to the first, in a fixed order: each
    // thread's registers to the same thread of the first warpgroup, through
    // the Q buffers
    float* red = reinterpret_cast<float*>(sbase + S::OFF_Q);
    __syncthreads();  // every step is done with the Q buffers
    if (wg == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        red[i * 128 + wt] = acc_k[i];
        red[(D / 2 + i) * 128 + wt] = acc_v[i];
      }
    }
    __syncthreads();
    if (wg == 1) continue;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      acc_k[i] += red[i * 128 + wt];
      acc_v[i] += red[(D / 2 + i) * 128 + wt];
    }

    // scale dK, round both to bf16 once, write from registers
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int kr = k0 + row0 + 8 * i;
      if (kr >= Skv) continue;
      const long long off = (((long long)b * Skv + kr) * Hkv + hk) * D + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int x = 4 * j + 2 * i;
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j) =
            pack_bf16(acc_k[x] * scale, acc_k[x + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j) =
            pack_bf16(acc_v[x], acc_v[x + 1]);
      }
    }
  }
}

// --- dQ on tensor cores: bf16, head_dim 64 or 128 -------------------------

// Shared memory of the dQ kernel, byte offsets from a 1024-byte-aligned
// base: each warpgroup's Q and dO tiles, then two stages each of K and V;
// every tile 64 rows of D columns (one 64-column panel at D = 64, two at
// 128). WGS warpgroups, each on its own 64 q rows, make a CTA: two at D =
// 128, where 128 q rows share each K and V tile of a kernel bound by the
// tensor cores; one at D = 64, bound by the bytes. There a thread takes
// 151 registers, so three one-warpgroup CTAs share an SM where one
// two-warpgroup CTA fits, and one CTA's loads overlap the others'
// products: 0.148 against 0.185 ms at CLIP's vision shape (PERF.md;
// __launch_bounds__(256, 2) on two warpgroups spills).
template <int D>
struct DqSmem {
  static constexpr int WGS = D == 64 ? 1 : NWG;
  static constexpr int TILE = 64 * D * 2;
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_DO = OFF_Q + WGS * TILE;
  static constexpr int OFF_K = OFF_DO + WGS * TILE;
  static constexpr int OFF_V = OFF_K + 2 * TILE;
  static constexpr int BYTES = OFF_V + 2 * TILE + 1024;  // + slack
};

template <int D>
__global__ void __launch_bounds__(128 * DqSmem<D>::WGS, 1)
flash_bwd_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dvec, __nv_bfloat16* __restrict__ dq, int Sq,
    int Skv, int Hq, int Hkv, Strides st, float scale, int causal) {
  using namespace sm90;
  static_assert(D == 64 || D == 128, "one or two 64-column panels");
  using S = DqSmem<D>;
  constexpr int NTH = 128 * S::WGS;   // threads a CTA
  constexpr int BQ_CTA = BR * S::WGS;  // q rows a CTA
  // the lbo of K read MN-major: its panel stride at D = 128; one panel at
  // D = 64, where no product reads it (sm90.cuh)
  constexpr uint32_t lbo = D == 128 ? PANEL : 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_off = Skv - Sq;
  // heaviest causal q block first: block x takes q block n_qb - 1 - x
  const int n_qb = (Sq + BQ_CTA - 1) / BQ_CTA;
  const int q0 = (n_qb - 1 - (int)blockIdx.x) * BQ_CTA;
  const int qw = q0 + BR * wg;   // this warpgroup's first q row
  // this thread's accumulator rows qw + row0 + 8i and columns
  // 8j + col0 + {0, 1} (keys in S and dP, head_dim in dQ)
  const int row0 = 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = scale * LOG2E;

  int n_tiles = (Skv + BK - 1) / BK;
  if (causal) {
    const int last_key = min(q0 + BQ_CTA, Sq) - 1 + q_off;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BK + 1);
  }
  const int wg_rows = max(min(BR, Sq - qw), 0);
  const int wg_last = wg_rows == 0 ? -1
                      : causal     ? min(qw + wg_rows - 1 + q_off, Skv - 1)
                                   : Skv - 1;

  const __nv_bfloat16* kb = k + b * st.k_b + hk * st.k_h;
  const __nv_bfloat16* vb = v + b * st.v_b + hk * st.v_h;
  const uint32_t qs = base + S::OFF_Q + wg * S::TILE;
  const uint32_t dos = base + S::OFF_DO + wg * S::TILE;
  if (n_tiles > 0) {
    load_tile_sw128<BR, 128, D>(qs, q + b * st.q_b + h * st.q_h, qw, Sq,
                                st.q_s, wt);
    load_tile_sw128<BR, 128, D>(dos, dout + b * st.o_b + h * st.o_h, qw, Sq,
                                st.o_s, wt);
    load_tile_sw128<BK, NTH, D>(base + S::OFF_K, kb, 0, Skv, st.k_s, tid);
    load_tile_sw128<BK, NTH, D>(base + S::OFF_V, vb, 0, Skv, st.v_s, tid);
  }
  cp_async_commit();
  // this thread's two rows' lse (log2 units) and Dvec, kept in registers
  float l2[2], dvc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = qw + row0 + 8 * i;
    const bool in = qr < Sq;
    l2[i] = in ? lse[(long long)bh * Sq + qr] * LOG2E : 0.f;
    dvc[i] = in ? dvec[(long long)bh * Sq + qr] : 0.f;
  }

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1
    if (t + 1 < n_tiles) {
      const uint32_t nxt = (stage ^ 1) * S::TILE;
      load_tile_sw128<BK, NTH, D>(base + S::OFF_K + nxt, kb, (t + 1) * BK,
                                  Skv, st.k_s, tid);
      load_tile_sw128<BK, NTH, D>(base + S::OFF_V + nxt, vb, (t + 1) * BK,
                                  Skv, st.v_s, tid);
    }
    cp_async_commit();
    const int k0 = t * BK;
    if (k0 > wg_last) continue;  // wholly above this warpgroup's diagonal
    const uint32_t kts = base + S::OFF_K + stage * S::TILE;
    const uint32_t vts = base + S::OFF_V + stage * S::TILE;

    // S = Q K^T and dP = dO V^T [BR x BK], head_dim in D / 16 k16 steps,
    // all operands K-major (the step moves 32 bytes inside a 64-column
    // panel)
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * PANEL + (kk & 3) * 32;
      wgmma_m64n64k16_ss(s, desc_sw128(qs + off, 16, 1024),
                         desc_sw128(kts + off, 16, 1024), kk);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * PANEL + (kk & 3) * 32;
      wgmma_m64n64k16_ss(dp, desc_sw128(dos + off, 16, 1024),
                         desc_sw128(vts + off, 16, 1024), kk);
    }
    wgmma_commit();

    // P = exp2(scale log2e S - lse log2e) while dP is still on the tensor
    // cores; masked entries selected to exactly 0 on the tiles that the
    // diagonal or the end of the keys cuts (a row that sees no key has lse
    // -1e30, and every tile it meets is cut)
    wgmma_wait<1>();
    fence_regs(s);
    const bool cut = k0 + BK > Skv || (causal && k0 + BK - 1 > qw + q_off);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * i + c];
          const float p = exp2f(fmaf(x, scale_log2, -l2[i]));
          if (cut) {
            const int kc = k0 + 8 * j + col0 + c;
            const int qr = qw + row0 + 8 * i;
            x = kc < Skv && (!causal || kc <= qr + q_off) ? p : 0.f;
          } else {
            x = p;
          }
        }
    // dS = P * (dP - Dvec) in f32
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int x = 4 * j + 2 * i + c;
          dp[x] = s[x] * (dp[x] - dvc[i]);
        }
    // dQ += dS K (m64nDk16): dS rounded to bf16 (k's dtype) in registers,
    // K read MN-major from the tile S read K-major, its kv rows the
    // reduction
    uint32_t da[BK / 16][4];
    to_a_operand(dp, da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_bt(acc, da[kk], desc_sw128(kts + kk * 16 * 128, lbo, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(da);
    fence_regs(acc);
  }
  cp_async_wait_all();

  // scale dQ, round to bf16 once, write from registers
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qr = qw + row0 + 8 * i;
    if (qr >= Sq) continue;
    __nv_bfloat16* row = dq + (((long long)b * Sq + qr) * Hq + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(
          acc[4 * j + 2 * i] * scale, acc[4 * j + 2 * i + 1] * scale);
  }
}

}  // namespace tc

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
  constexpr size_t smem =
      (size_t)(4 * 64 * (D + 1) + BQ * (BK + 1) + 2 * BQ) * sizeof(float);
  constexpr auto kern = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = sm90::smem_limit_once<kern>((int)smem);
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
  constexpr size_t smem =
      (size_t)(4 * 64 * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ) * sizeof(float);
  constexpr auto kern = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err = sm90::smem_limit_once<kern>((int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Skv + BK - 1) / BK, B * Hkv);
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dvec,
      (T*)dk, (T*)dv, Sq, Skv, Hq, Hkv, read_strides(st), scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* dvec, void* dk, void* dv, int B, int Sq,
                          int Skv, int Hq, int Hkv, const long long* st,
                          float scale, int causal, cudaStream_t stream) {
  constexpr auto kern = tc::flash_bwd_dkv_tc_kernel<D>;
  constexpr int smem = tc::DkvSmem<D>::BYTES;
  cudaError_t err = sm90::smem_limit_once<kern>(smem);
  if (err != cudaSuccess) return err;
  const int n_kt = (Skv + tc::BK - 1) / tc::BK;
  dim3 grid(causal ? (n_kt + 1) / 2 : n_kt, B * Hkv);
  kern<<<grid, tc::NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, lse, dvec,
      (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, Sq, Skv, Hq, Hkv,
      read_strides(st), scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq_tc(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* dvec, void* dq, int B, int Sq, int Skv,
                         int Hq, int Hkv, const long long* st, float scale,
                         int causal, cudaStream_t stream) {
  using S = tc::DqSmem<D>;
  constexpr auto kern = tc::flash_bwd_dq_tc_kernel<D>;
  cudaError_t err = sm90::smem_limit_once<kern>(S::BYTES);
  if (err != cudaSuccess) return err;
  constexpr int rows = tc::BR * S::WGS;   // q rows a CTA
  dim3 grid((Sq + rows - 1) / rows, B * Hq);
  kern<<<grid, 128 * S::WGS, S::BYTES, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)dout, lse, dvec,
      (__nv_bfloat16*)dq, Sq, Skv, Hq, Hkv, read_strides(st), scale, causal);
  return cudaGetLastError();
}

// 0 when q, k, v and dO start 16 bytes aligned and their 12 (batch, seq,
// head) strides are multiples of 8 elements, as the tensor-core kernels'
// 16-byte cp.async needs
int check_tc_alignment(const void* q, const void* k, const void* v,
                       const void* dout, const long long* strides) {
  unsigned long long bits = (unsigned long long)q | (unsigned long long)k |
                            (unsigned long long)v | (unsigned long long)dout;
  for (int i = 0; i < 12; ++i) bits |= (unsigned long long)strides[i] * 2;
  return bits % 16 ? (int)cudaErrorMisalignedAddress : 0;
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
#define DQ(T, DD) \
  return launch_dq<T, DD>(q, k, v, dout, l, dv, dq, B, Sq, Skv, Hq, Hkv, \
                          strides, scale, causal, s)
  if (dtype == 0) switch (D) {
    case 16: DQ(float, 16);
    case 32: DQ(float, 32);
    case 64: DQ(float, 64);
    case 128: DQ(float, 128);
  }
  if (dtype == 1) switch (D) {
    case 16: DQ(__nv_bfloat16, 16);
    case 32: DQ(__nv_bfloat16, 32);
  }
#undef DQ
  // bf16 with D = 64, 128: flash_bwd_dq_tc
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dq, on the tensor cores: bf16 (dtype 1) with D = 64 or
// 128 only, q, k, v and dO at 16-byte-aligned addresses with (batch, seq,
// head) strides in multiples of 8 elements; anything else returns an
// error.
extern "C" int flash_bwd_dq_tc(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* dvec, void* dq, int B, int Sq,
                               int Skv, int Hq, int Hkv, int D,
                               const long long* strides, float scale,
                               int causal, int dtype, void* stream) {
  if (dtype != 1 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  if (int err = check_tc_alignment(q, k, v, dout, strides)) return err;
  const float* l = (const float*)lse;
  const float* dvc = (const float*)dvec;
  if (D == 64)
    return launch_dq_tc<64>(q, k, v, dout, l, dvc, dq, B, Sq, Skv, Hq, Hkv,
                            strides, scale, causal, (cudaStream_t)stream);
  return launch_dq_tc<128>(q, k, v, dout, l, dvc, dq, B, Sq, Skv, Hq, Hkv,
                           strides, scale, causal, (cudaStream_t)stream);
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
#define DKV(T, DD) \
  return launch_dkv<T, DD>(q, k, v, dout, l, dvc, dk, dv, B, Sq, Skv, Hq, \
                           Hkv, strides, scale, causal, s)
  if (dtype == 0) switch (D) {
    case 16: DKV(float, 16);
    case 32: DKV(float, 32);
    case 64: DKV(float, 64);
    case 128: DKV(float, 128);
  }
  if (dtype == 1) switch (D) {
    case 16: DKV(__nv_bfloat16, 16);
    case 32: DKV(__nv_bfloat16, 32);
  }
#undef DKV
  // bf16 with D = 64, 128: flash_bwd_dkv_tc
  return (int)cudaErrorInvalidValue;
}

// As flash_bwd_dkv, on the tensor cores: bf16 (dtype 1) with D = 64 or
// 128 only, q, k, v and dO at 16-byte-aligned addresses with (batch, seq,
// head) strides in multiples of 8 elements; anything else returns an
// error.
extern "C" int flash_bwd_dkv_tc(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* dvec, void* dk, void* dv, int B,
                                int Sq, int Skv, int Hq, int Hkv, int D,
                                const long long* strides, float scale,
                                int causal, int dtype, void* stream) {
  if (dtype != 1 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  if (int err = check_tc_alignment(q, k, v, dout, strides)) return err;
  const float* l = (const float*)lse;
  const float* dvc = (const float*)dvec;
  if (D == 64)
    return launch_dkv_tc<64>(q, k, v, dout, l, dvc, dk, dv, B, Sq, Skv, Hq,
                             Hkv, strides, scale, causal,
                             (cudaStream_t)stream);
  return launch_dkv_tc<128>(q, k, v, dout, l, dvc, dk, dv, B, Sq, Skv, Hq,
                            Hkv, strides, scale, causal,
                            (cudaStream_t)stream);
}
