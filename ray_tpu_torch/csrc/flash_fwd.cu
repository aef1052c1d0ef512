// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces: ray_tpu/ops/attention.py `_flash_fwd_kernel`, launched by
// `flash_attention_tpu` (the Pallas TPU kernel on the whole-prompt
// prefill path, runner.prefill -> ops.attention.attention).
//
// What it computes (the Pallas semantics, kept exactly):
//   O = softmax(scale * Q K^T) V per (batch, q head), GQA by h / (Hq/Hkv);
//   causal mask with bottom-right alignment: key j visible to query i when
//   j <= i + (Skv - Sq); masked entries contribute exactly 0 (select, so a
//   fully masked row gives O = 0, not a uniform average); online softmax in
//   f32; P is rounded to the value dtype before the PV product (the TPU
//   kernel's p.astype(v.dtype)) while the row sum uses the f32 P; writes O
//   in the input dtype and LSE = m + log(max(l, 1e-30)) in f32, which the
//   backward kernels of a later slice read.
//
// What bounds it on the H100: at the 8B shapes (32 q heads, 8 kv heads,
// D=128, causal, bf16) the work is 2 causal products, ~2.2 GFLOP on
// ~10.5 MB at S=512 (prefill) and 35.4 GFLOP on ~42 MB at S=2048
// (training, 64 launches a step): bound by operations on the tensor cores
// at S=2048 (~0.035 ms), by the bytes at S=512 (~0.003 ms). At CLIP
// ViT-B/16's vision shape (B=128, S=197, 12 heads of 64, non-causal) it
// is 15.3 GFLOP on ~156 MB: bound by the bytes (~0.047 ms).
//
// Two kernels:
//
// flash_fwd_tc_kernel<D>: bf16 with D = 64 or 128 (the serving and
// training paths, CLIP's towers), on the tensor cores (wgmma, sm90.cuh).
// D sets the tiles (one 64-column swizzle panel a row at 64, two at 128),
// the D / 16 k-steps of Q K^T, the D / 2 accumulator registers of O and
// the N of the P V product; at D = 64 two CTAs share an SM (49 KB of
// shared memory and 120 registers a thread each), so one CTA's loads
// overlap the other's products. A
// CTA is two warpgroups on 128 q rows of one (b, q head), each warpgroup
// on its own 64 rows; its Q tile is loaded once into the
// 128-byte-swizzled layout and stays. K
// and V stream through a cp.async double buffer that both warpgroups
// share: the next kv tile loads while this one's products run, one
// __syncthreads per tile. Per kv tile a warpgroup computes S = Q K^T
// (m64n64k16, both operands K-major from shared memory), masks by select
// only on tiles the causal diagonal or the sequence end cuts, and runs the
// online softmax in registers in the exp2 domain (row max in-thread, then
// over the four lanes of a quad; masked entries give exactly 0). P, rounded
// to bf16 (v's dtype, the TPU kernel's p.astype), becomes the A operand of
// O += P V (m64nDk16) in registers, V read MN-major from its tile; the
// row sum uses the f32 P. O stays in D / 2 f32 registers per thread. A
// warpgroup skips the tiles wholly above its own diagonal but reaches every
// barrier. Causal CTAs launch heaviest q block first, so the tail is
// short. What bounds it now is how much of the tensor cores' time two
// warpgroups keep busy between the softmax and the per-tile sync, not the
// bytes.
//
// flash_fwd_kernel (f32 with D = 16, 32, 64 or 128, and bf16 with D = 16
// or 32): the first version, with f32 FMAs out of shared memory (no
// wgmma, no TMA), bound by shared-memory bandwidth and the f32 FMA rate,
// far from the tensor-core bound; the tests hold f32 at 1e-4, which a
// tensor-core path cannot. One CTA of 256
// threads per (64-row q tile, b * Hq) loops over 64-row kv tiles, skipping
// tiles wholly above the causal diagonal. Q, K and V tiles are staged in
// shared memory as f32 (rows are padded by one word so the strided reads
// of the QK^T loop hit distinct banks); each thread owns a 4x4 block of S
// and a 4 x D/16 block of O. The online-softmax row statistics live in
// shared memory, one warp per eight rows. D maps onto the 16 columns of
// threads as D / 16 values a thread (1 at D = 16, 2 at 32), and the shared
// tiles shrink with D.
//
// Both take any Sq and Skv and strided [B, S, H, D] inputs without a
// transposed copy: rows and keys past the sequence ends load as zero and
// are masked by select, so no NaN or garbage from past the end reaches O.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr float NEG_INF = -1e30f;

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

// With no minimum of CTAs an SM, ptxas aims at 80 registers and spills
// at D = 128 (f32), where the shared tiles allow one CTA an SM anyway: a
// minimum of 1 lets it take what it needs. The other widths declare 0,
// which ptxas reads as no minimum.
template <int D>
constexpr int min_ctas() { return D == 128 ? 1 : 0; }

template <typename T, int D>
__global__ void __launch_bounds__(NT, min_ctas<D>()) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse,
    int Sq, int Skv, int Hq, int Hkv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    float scale, int causal) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);       // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);       // [BK][D]
  float* Ss = Vs + BK * D;             // [BQ][BK + 1]
  float* m_s = Ss + BQ * (BK + 1);     // [BQ] running max
  float* l_s = m_s + BQ;               // [BQ] running sum
  float* c_s = l_s + BQ;               // [BQ] this tile's correction

  constexpr int DJ = D / 16;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int q_off = Skv - Sq;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + hk * k_sh;
  const T* vb = v + b * v_sb + hk * v_sh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int qr = q0 + r;
    Qs[r * (D + 1) + d] = qr < Sq ? to_f(qb[(long long)qr * q_ss + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
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
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      const int kr = k0 + r;
      const bool ok = kr < Skv;
      Ks[r * (D + 1) + d] = ok ? to_f(kb[(long long)kr * k_ss + d]) : 0.f;
      Vs[r * D + d] = ok ? to_f(vb[(long long)kr * v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int kc = k0 + c, qr = q0 + r;
        const bool ok = kc < Skv && (!causal || kc <= qr + q_off);
        Ss[r * (BK + 1) + c] = ok ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp per BQ/8 rows, two keys per lane
    for (int rr = 0; rr < BQ / (NT / 32); ++rr) {
      const int r = warp * (BQ / (NT / 32)) + rr;
      const float s0 = Ss[r * (BK + 1) + lane];
      const float s1 = Ss[r * (BK + 1) + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      // masked entries are exactly 0: exp(NEG_INF - NEG_INF) would be 1
      const float p0 = s0 > NEG_INF * 0.5f ? expf(s0 - m_new) : 0.f;
      const float p1 = s1 > NEG_INF * 0.5f ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      // P rounded to the value dtype before PV, as the TPU kernel does
      Ss[r * (BK + 1) + lane] = to_f(from_f<T>(p0));
      Ss[r * (BK + 1) + lane + 32] = to_f(from_f<T>(p1));
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= c;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ss[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qr = q0 + r;
    if (qr >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = o + (((long long)b * Sq + qr) * Hq + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / l);
    if (tx == 0) lse[((long long)b * Hq + h) * Sq + qr] = m_s[r] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                   const long long* st, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem =
      (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ) *
      sizeof(float);
  constexpr auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = sm90::smem_limit_once<kern>((int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, Sq, Skv, Hq, Hkv,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale,
      causal);
  return cudaGetLastError();
}

// --- forward on tensor cores: bf16, head_dim 64 or 128 --------------------

namespace tc {

constexpr int BM = 64;    // q rows per warpgroup: the M of every product
constexpr int BN = 64;    // kv rows per tile
constexpr int NWG = 2;    // warpgroups, each on its own BM q rows
constexpr int NT = 128 * NWG;
constexpr int BQ = BM * NWG;   // q rows per CTA
constexpr int PANEL = 64 * 128;   // a 64-row tile's 64-column panel, bytes
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory, byte offsets from a 1024-byte-aligned base: each
// warpgroup's Q tile, then two stages each of K and V; every tile 64 rows
// of D columns (one 64-column panel at D = 64, two at 128).
template <int D>
struct Smem {
  static constexpr int TILE = 64 * D * 2;
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_K = OFF_Q + NWG * TILE;
  static constexpr int OFF_V = OFF_K + 2 * TILE;
  static constexpr int BYTES = OFF_V + 2 * TILE + 1024;   // + alignment slack
};

// Strides in elements, (batch, seq, head) of q, k and v.
struct Strides {
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
};

// At D = 64 a CTA needs 49 KB of shared memory and 120 registers a
// thread, so two share an SM and one CTA's loads overlap the other's
// products; at D = 128 (97 KB, 159 registers) one fits. Asking ptxas for
// two at D = 64 (__launch_bounds__(256, 2)) changed neither the registers
// nor the time on the H100 (PERF.md), so the minimum is one at both.
template <int D>
__global__ void __launch_bounds__(NT, 1) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int Sq, int Skv, int Hq, int Hkv, Strides st,
    float scale, int causal) {
  using namespace sm90;
  static_assert(D == 64 || D == 128, "one or two 64-column panels");
  using S = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;

  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  const int warp = wt / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int q_off = Skv - Sq;
  // heaviest causal q block first: block x takes q block n_qb - 1 - x
  const int n_qb = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qb - 1 - (int)blockIdx.x) * BQ;
  const int qw = q0 + BM * wg;   // this warpgroup's first q row
  // this thread's accumulator rows qw + row0 + 8i and columns
  // 8j + col0 + {0, 1} (keys in S, head_dim in O)
  const int row0 = 16 * warp + lane / 4;
  const int col0 = 2 * (lane % 4);
  const float scale_log2 = scale * LOG2E;

  int n_tiles = (Skv + BN - 1) / BN;
  if (causal) {
    // the last key any real row of the CTA sees
    const int last_key = min(q0 + BQ, Sq) - 1 + q_off;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BN + 1);
  }
  // the last key this warpgroup's real rows see; -1 when none
  const int wg_rows = max(min(BM, Sq - qw), 0);
  const int wg_last = wg_rows == 0 ? -1
                      : causal     ? min(qw + wg_rows - 1 + q_off, Skv - 1)
                                   : Skv - 1;

  const __nv_bfloat16* kb = k + b * st.k_b + hk * st.k_h;
  const __nv_bfloat16* vb = v + b * st.v_b + hk * st.v_h;
  const uint32_t qs = base + S::OFF_Q + wg * S::TILE;
  if (n_tiles > 0) {
    load_tile_sw128<BM, 128, D>(qs, q + b * st.q_b + h * st.q_h, qw, Sq,
                                st.q_s, wt);
    load_tile_sw128<BN, NT, D>(base + S::OFF_K, kb, 0, Skv, st.k_s, tid);
    load_tile_sw128<BN, NT, D>(base + S::OFF_V, vb, 0, Skv, st.v_s, tid);
  }
  cp_async_commit();

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // running max (log2 domain) and this thread's share of the row sum
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // tile t is in; every thread is done with tile t - 1
    if (t + 1 < n_tiles) {
      const uint32_t nxt = (stage ^ 1) * S::TILE;
      load_tile_sw128<BN, NT, D>(base + S::OFF_K + nxt, kb, (t + 1) * BN,
                                 Skv, st.k_s, tid);
      load_tile_sw128<BN, NT, D>(base + S::OFF_V + nxt, vb, (t + 1) * BN,
                                 Skv, st.v_s, tid);
    }
    cp_async_commit();
    const int k0 = t * BN;
    if (k0 > wg_last) continue;  // wholly above this warpgroup's diagonal
    const uint32_t kts = base + S::OFF_K + stage * S::TILE;
    const uint32_t vts = base + S::OFF_V + stage * S::TILE;

    // S = Q K^T [BM x BN], head_dim in D / 16 k16 steps (K-major: the step
    // moves 32 bytes inside a 64-column panel)
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * PANEL + (kk & 3) * 32;
      wgmma_m64n64k16_ss(s, desc_sw128(qs + off, 16, 1024),
                         desc_sw128(kts + off, 16, 1024), kk);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // to the log2 domain; masked entries NEG_INF, on the tiles that the
    // diagonal or the end of the keys cuts
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
    const bool cut = k0 + BN > Skv || (causal && k0 + BN - 1 > qw + q_off);
    if (cut) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kc = k0 + 8 * j + col0 + c;
            const int qr = qw + row0 + 8 * i;
            if (kc >= Skv || (causal && kc > qr + q_off))
              s[4 * j + 2 * i + c] = NEG_INF;
          }
    }
    // online softmax: P = exp2(s - m_new); a row that has seen no key yet
    // keeps m = NEG_INF and takes 0 as its max, so its P is exactly 0
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = quad_max(mx);
      const float corr = exp2f(m[i] - mx);
      m[i] = mx;
      const float mu = mx == NEG_INF ? 0.f : mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * j + 2 * i + c];
          x = exp2f(x - mu);
          sum += x;
        }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 2 * i] *= corr;
        acc[4 * j + 2 * i + 1] *= corr;
      }
    }

    // O += P V (m64nDk16): P rounded to bf16 in registers, V read
    // MN-major, its kv rows the reduction
    uint32_t pa[BN / 16][4];
    to_a_operand(s, pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_bt(acc, pa[kk], desc_sw128(vts + kk * 16 * 128,
                                          D == 128 ? PANEL : 16, 1024));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pa);
    fence_regs(acc);
  }
  cp_async_wait_all();

  // O / l rounded to bf16 once, written from registers; LSE in natural-log
  // units, NEG_INF on a row that saw no key (its O is 0)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = fmaxf(quad_sum(l[i]), 1e-30f);
    const int qr = qw + row0 + 8 * i;
    if (qr >= Sq) continue;
    __nv_bfloat16* row = o + (((long long)b * Sq + qr) * Hq + h) * D + col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[4 * j + 2 * i] / lt, acc[4 * j + 2 * i + 1] / lt);
    if (lane % 4 == 0)
      lse[(long long)bh * Sq + qr] =
          (m[i] == NEG_INF ? NEG_INF : m[i] * LN2) + logf(lt);
  }
}

}  // namespace tc

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                      const long long* s, float scale, int causal,
                      cudaStream_t stream) {
  constexpr auto kern = tc::flash_fwd_tc_kernel<D>;
  constexpr int smem = tc::Smem<D>::BYTES;
  cudaError_t err = sm90::smem_limit_once<kern>(smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + tc::BQ - 1) / tc::BQ, B * Hq);
  kern<<<grid, tc::NT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, Sq, Skv, Hq, Hkv,
      tc::Strides{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8]},
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: q, k, v (batch, seq, head)
// in elements; the head_dim stride must be 1. Returns cudaGetLastError().
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int Sq, int Skv, int Hq,
                         int Hkv, int D, const long long* strides,
                         float scale, int causal, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
#define FWD(T, DD) \
  return launch<T, DD>(q, k, v, o, l, B, Sq, Skv, Hq, Hkv, strides, scale, \
                       causal, s)
  if (dtype == 0) switch (D) {
    case 16: FWD(float, 16);
    case 32: FWD(float, 32);
    case 64: FWD(float, 64);
    case 128: FWD(float, 128);
  }
  if (dtype == 1) switch (D) {
    case 16: FWD(__nv_bfloat16, 16);
    case 32: FWD(__nv_bfloat16, 32);
  }
#undef FWD
  return (int)cudaErrorInvalidValue;  // bf16 with D = 64, 128: flash_fwd_tc
}

// As flash_fwd, on the tensor cores: bf16 (dtype 1) with D = 64 or 128
// only, q, k and v at 16-byte-aligned addresses with (batch, seq, head)
// strides in multiples of 8 elements; anything else returns an error.
extern "C" int flash_fwd_tc(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int Sq, int Skv,
                            int Hq, int Hkv, int D, const long long* strides,
                            float scale, int causal, int dtype,
                            void* stream) {
  if (dtype != 1 || (D != 64 && D != 128)) return (int)cudaErrorInvalidValue;
  unsigned long long bits = (unsigned long long)q | (unsigned long long)k |
                            (unsigned long long)v;
  for (int i = 0; i < 9; ++i) bits |= (unsigned long long)strides[i] * 2;
  if (bits % 16) return (int)cudaErrorMisalignedAddress;
  if (D == 64)
    return launch_tc<64>(q, k, v, o, (float*)lse, B, Sq, Skv, Hq, Hkv,
                         strides, scale, causal, (cudaStream_t)stream);
  return launch_tc<128>(q, k, v, o, (float*)lse, B, Sq, Skv, Hq, Hkv,
                        strides, scale, causal, (cudaStream_t)stream);
}
