// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: ray_tpu/ops/paged_attention.py:51 `_kernel`, launched by
// `paged_decode_attention` (the Pallas TPU kernel behind
// runner.decode_burst's attend_paged, once per layer per burst step).
//
// What it computes (the Pallas semantics): for each sequence b and kv head
// g, the `rep` query heads of that group attend over the cached positions
// [0, ctx_len[b]) found through the block table (position t lives in page
// block_tables[b, t / page_size] at offset t % page_size of the one-layer
// cache [P, page, kvh, hd]; entries clamped to [0, P)), then over the
// in-flight burst tail new_k/new_v[b, 0:new_len[b]]. Softmax scale
// hd**-0.5, the softmax, its weights P and every sum in f32, the output
// rounded to q's dtype. Masked positions contribute exactly 0: their K and
// V are never read (the copy zero-fills them) and their weights are
// selected to 0, never multiplied, so NaN or garbage on the dump page
// (page 0) or past ctx_len inside the last page cannot reach the output. A
// row with ctx_len + new_len == 0 gives exactly 0.
//
// What bounds it on the H100: decode reads every valid K and V row once
// and does ~4*rep*hd flops per row, far below the ~295 flop/byte balance
// point, so it is bound by memory bytes (at the 8k shape, B=4, kvh=8,
// hd=128, 7,682 positions, ~126 MB: ~38 us at 3.35 TB/s). The TPU kernel
// walks a sequence's pages in order, carrying the softmax state across its
// "arbitrary" grid axis. This file's first design did the same with one
// CTA of 128 threads per (kv head, sequence), 32 positions a step and
// 2-byte loads: 64 CTAs on 132 SMs at B=8, few loads in flight, 1/64 of
// the bound.
//
// Design (flash decoding):
//   - Split-KV across CTAs. The grid is (kvh, B, n_splits + 1): CTA z <
//     n_splits takes the positions of pages [z*pps, (z+1)*pps) of row b,
//     the last CTA the burst tail. The wrapper derives pps and n_splits
//     from the shapes and the SM count alone (about two CTAs per SM; no
//     device value is read on the host). A CTA whose pages lie at or past
//     ctx_len writes the empty partial (m = -1e30, l = 0, acc = 0) and
//     exits; the others write their partial (m, l, acc) in f32 to a
//     workspace the wrapper allocates.
//   - Loads: the four warps of a CTA take 16-row tiles in turn (warp w:
//     tiles w, w+4, ...), each through its own 3-stage cp.async ring in
//     shared memory: 16-byte copies, a 256-byte K or V row being 16
//     neighbouring threads, two tiles in flight while one is scored, one
//     page lookup a tile. No __syncthreads in the loop, only __syncwarp.
//     Each row's 16-byte chunks are XOR-swizzled by row, so the reads
//     below are free of bank conflicts.
//   - One kernel for f32 and bf16, SIMT FMAs in f32: the scores take two
//     lanes a key row against q (scaled, f32) in shared memory, each lane
//     reading its 16-byte chunks of K and widening them in registers;
//     P V takes one lane per hd/32 dims, V widened in registers and P kept
//     in f32 (shared memory, per warp). At a few flops a byte the work
//     needs no tensor cores.
//   - Small heads (hd 16 and 32, `tiny` and `jamba_tiny`): a K or V row is
//     2-8 chunks, so the swizzle period shrinks to the row's chunks, and
//     in P V, where hd/32 lanes would be 0 or under 4 bytes a lane, the
//     warp splits into groups that each take every G-th row of the tile,
//     one 4-byte (or wider) slice of it a lane; the groups' sums are
//     added by shuffles after the last tile.
//   - The four warps' states are merged through shared memory in warp
//     order; a second small launch merges the splits of each (b, g): it
//     rescales split i by exp(m_i - m) (weight exactly 0 for a split with
//     l = 0, so an empty split's exp(-1e30 - -1e30) = 1 never counts) and
//     sums in split order. No atomics: a second launch gives the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::cp_async_16;
using sm90::cp_async_commit;
using sm90::cp_async_wait;
using sm90::smem_u32;

constexpr int NT = 128;          // threads per CTA
constexpr int NWARP = NT / 32;
constexpr int ROWS = 16;         // key rows a warp takes per tile
constexpr int STAGES = 3;        // tiles a warp has in shared memory
constexpr int MAX_REP = 16;
constexpr int MAX_PPS = 512;     // pages a split (its table slice is in smem)
constexpr int MAX_SPLITS = 1536; // the combine keeps (2 splits + 3) x rep floats
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// N elements of T (4, 8 or 16 bytes) from shared memory, widened to f32
// in registers (a bf16 is the top half of its f32)
template <typename T, int N>
__device__ __forceinline__ void load_row(const unsigned char* p,
                                         float (&f)[N]) {
  constexpr int W = N * (int)sizeof(T) / 4;   // 32-bit words
  static_assert(W == 1 || W == 2 || W == 4, "4, 8 or 16 bytes");
  uint32_t w[W];
  if constexpr (W == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (W == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

struct Params {
  const void *q, *ck, *cv, *nk, *nv;
  const int *bt, *ctx_len, *new_len;
  float* part;
  void* out;
  int B, kvh, rep, P, page_size, n_pages, K, pps, n_splits;
  float scale;
};

// K/V tiles in shared memory: per warp STAGES stages of ROWS rows of K
// then ROWS rows of V, each row's 16-byte chunk c stored at c ^ (row % SW),
// SW the row's chunks up to 8 (2 for a bf16 row of 16 dims)
template <typename T, int HD>
struct Tiles {
  static constexpr int RB = HD * (int)sizeof(T);   // bytes of a K or V row
  static constexpr int NC = RB / 16;               // 16-byte chunks a row
  static constexpr int EPC = 16 / (int)sizeof(T);  // elements a chunk
  static constexpr int SW = NC < 8 ? NC : 8;       // swizzle period, rows
  static constexpr int STAGE = ROWS * RB;          // K (or V) of one tile
  static constexpr int KV_BYTES = NWARP * STAGES * 2 * STAGE;
  static_assert((ROWS * NC) % 32 == 0 && NC >= 2, "whole chunks per lane");

  // byte offset of chunk c of tile row `row`
  static __device__ __forceinline__ int at(int row, int c) {
    return row * RB + ((c ^ (row & (SW - 1))) << 4);
  }
};

// What one CTA (kv head g, sequence b, split z) reads: positions
// [lo, lo + n) of the cache (pages z*pps ...), or [0, n) of the burst tail
// for z == n_splits; where its partial goes; and the copies of its tiles.
template <typename T, int HD>
struct SplitCta {
  using C = Tiles<T, HD>;
  const Params& a;
  int* tbl;   // this split's page ids, clamped to [0, P)
  int g, b, z, lo, n;
  bool tail, whole_tiles;
  long long pos_stride;
  float *pacc, *pml;
  const T *ksrc, *vsrc;

  __device__ SplitCta(const Params& a_, int* tbl_) : a(a_), tbl(tbl_) {
    g = blockIdx.x;
    b = blockIdx.y;
    z = blockIdx.z;
    const int S = a.n_splits + 1;
    tail = z == a.n_splits;
    // partial of (b, g, z): acc [rep][HD], then (m, l) [rep][2] after all
    const long long pidx = ((long long)b * a.kvh + g) * S + z;
    pacc = a.part + pidx * a.rep * HD;
    pml = a.part + (long long)a.B * a.kvh * S * a.rep * HD + pidx * a.rep * 2;
    lo = 0;
    if (tail) {
      n = max(0, min(a.new_len[b], a.K));
    } else {
      const int ctx = max(0, min(a.ctx_len[b], a.n_pages * a.page_size));
      lo = z * a.pps * a.page_size;
      n = max(0, min(lo + a.pps * a.page_size, ctx) - lo);
    }
    ksrc = (const T*)(tail ? a.nk : a.ck);
    vsrc = (const T*)(tail ? a.nv : a.cv);
    pos_stride = (long long)a.kvh * HD;
    // a tile of the tail, or of pages whose size is a multiple of ROWS,
    // lies in one run of consecutive positions: one page lookup a tile
    whole_tiles = tail || a.page_size % ROWS == 0;
  }

  // the empty partial; the combine gives it weight exactly 0
  __device__ void write_empty(int tid) const {
    for (int i = tid; i < a.rep * HD; i += NT) pacc[i] = 0.f;
    for (int r = tid; r < a.rep; r += NT) {
      pml[2 * r] = NEG_INF;
      pml[2 * r + 1] = 0.f;
    }
  }

  __device__ void load_table(int tid) const {
    if (tail) return;
    const int np = (n + a.page_size - 1) / a.page_size;
    for (int i = tid; i < np; i += NT)
      tbl[i] = min(max(a.bt[(long long)b * a.n_pages + z * a.pps + i], 0),
                   a.P - 1);
  }

  // element offset of row t (0 <= t < n); lo is a page boundary, so
  // position t's page is tbl[t / page_size]
  __device__ long long row_off(int t) const {
    if (tail) return ((long long)b * a.K + t) * pos_stride + g * HD;
    const long long page = tbl[t / a.page_size];
    return (page * a.page_size + t % a.page_size) * pos_stride + g * HD;
  }

  // this lane's share of the 16-byte copies of tile `tile` (K and V rows
  // [tile * ROWS, + ROWS), zero past n) into stage st of the warp's buffer
  __device__ void issue(unsigned char* wbuf, int lane, int tile,
                        int st) const {
    const uint32_t kd = smem_u32(wbuf + st * 2 * C::STAGE);
    const uint32_t vd = kd + C::STAGE;
    const int t0 = tile * ROWS;
    const long long base = whole_tiles ? row_off(t0) : 0;
#pragma unroll
    for (int i = 0; i < ROWS * C::NC / 32; ++i) {
      const int idx = lane + 32 * i, row = idx / C::NC, c = idx % C::NC;
      const bool ok = t0 + row < n;
      const long long off =
          !ok ? 0
              : (whole_tiles ? base + row * pos_stride : row_off(t0 + row)) +
                    c * C::EPC;
      const uint32_t dst = C::at(row, c);
      cp_async_16(kd + dst, ksrc + off, ok ? 16 : 0);
      cp_async_16(vd + dst, vsrc + off, ok ? 16 : 0);
    }
  }
};

// The four warps' states, (m, l) [NWARP][R] and acc [NWARP][R][HD] in
// shared memory, merged in warp order into the CTA's partial; a warp that
// saw no position (l = 0) has weight exactly 0.
template <int HD, int R>
__device__ void merge_warps(const float* redm, const float* redl,
                            const float* reda, int rep, float* pacc,
                            float* pml, int tid) {
  for (int i = tid; i < rep * HD; i += NT) {
    const int r = i / HD, d = i % HD;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) M = fmaxf(M, redm[w * R + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float lw = redl[w * R + r];
      if (lw > 0.f) {
        const float wt = expf(redm[w * R + r] - M);
        L = fmaf(wt, lw, L);
        A = fmaf(wt, reda[(w * R + r) * HD + d], A);
      }
    }
    pacc[i] = A;
    if (d == 0) {
      pml[2 * r] = M;
      pml[2 * r + 1] = L;
    }
  }
}

// The tiles of a warp: STAGES - 1 ahead in flight, one group committed per
// tile slot (empty past the end), so wait<STAGES - 1> means "this tile".
// body(k_tile_bytes, v_tile_bytes, nvalid) scores one tile.
template <typename T, int HD, typename Body>
__device__ __forceinline__ void for_each_tile(const SplitCta<T, HD>& cta,
                                              unsigned char* wbuf, int warp,
                                              int lane, Body&& body) {
  using C = Tiles<T, HD>;
  const int n_tiles = (cta.n + ROWS - 1) / ROWS;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (warp + k * NWARP < n_tiles) cta.issue(wbuf, lane, warp + k * NWARP, k);
    cp_async_commit();
  }
  int st = 0;
  for (int tile = warp; tile < n_tiles; tile += NWARP) {
    const int ahead = tile + (STAGES - 1) * NWARP;
    if (ahead < n_tiles)
      cta.issue(wbuf, lane, ahead, (st + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const unsigned char* kb = wbuf + st * 2 * C::STAGE;
    body(kb, kb + C::STAGE, min(ROWS, cta.n - tile * ROWS));
    __syncwarp();
    st = (st + 1) % STAGES;
  }
  cp_async_wait<0>();
}

// One split of one (b, g), SIMT FMAs in f32 for both dtypes. R: rep
// rounded up to 4, 8 or 16 (padding q rows zero). In P V each lane
// accumulates DPL dims (at least 4 bytes of a V row); at HD >= 64 the warp
// spans a row and walks the tile's rows in turn, at HD = 16 or 32 it is G
// groups of HD / DPL lanes, group i taking rows i, i + G, ..., and the
// groups' sums are added up (in a fixed order) at the end.
template <typename T, int HD, int R>
__global__ void __launch_bounds__(NT, 1)
    paged_decode_split_kernel(const Params a) {
  using C = Tiles<T, HD>;
  constexpr int HALF = C::NC / 2;   // chunks a lane scores
  constexpr int DPL = HD / 32 * (int)sizeof(T) >= 4 ? HD / 32
                                                    : 4 / (int)sizeof(T);
  constexpr int LPG = HD / DPL;     // lanes a group, one V row
  constexpr int G = 32 / LPG;       // groups: V rows a step
  static_assert(NWARP * R * (HD + 2) * 4 <= C::KV_BYTES, "merge area");
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem + C::KV_BYTES);  // [R][HD]
  float* Ps = Qs + R * HD;                          // [NWARP][ROWS][R]
  int* tbl = reinterpret_cast<int*>(Ps + NWARP * ROWS * R);
  const SplitCta<T, HD> cta(a, tbl);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (cta.n == 0) {
    cta.write_empty(tid);
    return;
  }
  const T* q = (const T*)a.q + ((long long)cta.b * a.kvh + cta.g) * a.rep * HD;
  for (int i = tid; i < R * HD; i += NT)
    Qs[i] = i < a.rep * HD ? to_f(q[i]) * a.scale : 0.f;
  cta.load_table(tid);
  __syncthreads();

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
  }
  float* pw = Ps + warp * ROWS * R;
  const int j = lane & (ROWS - 1), h = lane >> 4;   // score phase: row, half
  const int grp = lane / LPG;                      // P V phase: row group,
  const int ob = lane % LPG * DPL * (int)sizeof(T);  // byte offset in a row
  unsigned char* wbuf = smem + warp * STAGES * 2 * C::STAGE;

  for_each_tile(cta, wbuf, warp, lane, [&](const unsigned char* kb,
                                           const unsigned char* vb,
                                           int nvalid) {
    // scores: two lanes a key row, q broadcast from shared memory
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll
    for (int cc = 0; cc < HALF; ++cc) {
      const int c = h * HALF + cc;
      float kf[C::EPC];
      load_row<T>(kb + C::at(j, c), kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4* qp =
            reinterpret_cast<const float4*>(Qs + r * HD + c * C::EPC);
#pragma unroll
        for (int e = 0; e < C::EPC / 4; ++e) {
          const float4 qv = qp[e];
          s[r] = fmaf(qv.x, kf[4 * e], s[r]);
          s[r] = fmaf(qv.y, kf[4 * e + 1], s[r]);
          s[r] = fmaf(qv.z, kf[4 * e + 2], s[r]);
          s[r] = fmaf(qv.w, kf[4 * e + 3], s[r]);
        }
      }
    }
    const bool ok = j < nvalid;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sr = s[r] + __shfl_xor_sync(FULL, s[r], 16);
      float mx = ok ? sr : NEG_INF;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float corr = expf(m[r] - mn);
      // select, not multiply: a masked position is exactly 0
      const float p = ok ? expf(sr - mn) : 0.f;
      l[r] = l[r] * corr + (h == 0 ? p : 0.f);   // per-lane partial sum
      m[r] = mn;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= corr;
      if (h == 0) pw[j * R + r] = p;
    }
    __syncwarp();
    // P V: this lane's DPL dims of every query row, its group's rows
    for (int jj = grp; jj < nvalid; jj += G) {
      float vf[DPL];
      load_row<T>(vb + C::at(jj, ob >> 4) + (ob & 15), vf);
      const float4* pp = reinterpret_cast<const float4*>(pw + jj * R);
#pragma unroll
      for (int r4 = 0; r4 < R / 4; ++r4) {
        const float4 p4 = pp[r4];
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          acc[4 * r4][e] = fmaf(p4.x, vf[e], acc[4 * r4][e]);
          acc[4 * r4 + 1][e] = fmaf(p4.y, vf[e], acc[4 * r4 + 1][e]);
          acc[4 * r4 + 2][e] = fmaf(p4.z, vf[e], acc[4 * r4 + 2][e]);
          acc[4 * r4 + 3][e] = fmaf(p4.w, vf[e], acc[4 * r4 + 3][e]);
        }
      }
    }
  });

#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      l[r] += __shfl_xor_sync(FULL, l[r], off);
    // the groups' sums of P V (G = 1 at HD >= 64: nothing to add)
#pragma unroll
    for (int off = LPG; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        acc[r][e] += __shfl_xor_sync(FULL, acc[r][e], off);
  }

  // merge the four warps through the (now free) K/V area
  __syncthreads();
  float* redm = reinterpret_cast<float*>(smem);   // [NWARP][R]
  float* redl = redm + NWARP * R;                 // [NWARP][R]
  float* reda = redl + NWARP * R;                 // [NWARP][R][HD]
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      redm[warp * R + r] = m[r];
      redl[warp * R + r] = l[r];
    }
  }
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        reda[(warp * R + r) * HD + ob / (int)sizeof(T) + e] = acc[r][e];
  }
  __syncthreads();
  merge_warps<HD, R>(redm, redl, reda, a.rep, cta.pacc, cta.pml, tid);
}

// CTA (g, b, c) merges the n_splits + 1 partials of (b, g) for elements
// [c * NT, (c + 1) * NT) of its rep x HD outputs: the weights of each split
// (exp(m_i - m), exactly 0 for a split with l = 0) and the sum L first, in
// shared memory, then one output element a thread, summed in split order.
template <typename T, int HD>
__global__ void __launch_bounds__(NT) paged_decode_combine_kernel(
    const float* __restrict__ part, T* __restrict__ out, int B, int kvh,
    int rep, int S) {
  extern __shared__ float wsm[];   // [S][rep] (m, l), then L [rep]
  float* Ls = wsm + 2 * S * rep;
  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long long p0 = ((long long)b * kvh + g) * S;
  const float* ml = part + (long long)B * kvh * S * rep * HD + p0 * rep * 2;
  // (m, l) of every (z, r); then, in place of m, the weight of (z, r)
  for (int i = tid; i < 2 * S * rep; i += NT) wsm[i] = ml[i];
  __syncthreads();
  for (int r = tid; r < rep; r += NT) {
    float M = NEG_INF;
    for (int z = 0; z < S; ++z) M = fmaxf(M, wsm[2 * (z * rep + r)]);
    float L = 0.f;
    for (int z = 0; z < S; ++z) {
      const float lz = wsm[2 * (z * rep + r) + 1];
      const float w = lz > 0.f ? expf(wsm[2 * (z * rep + r)] - M) : 0.f;
      wsm[2 * (z * rep + r)] = w;
      L = fmaf(w, lz, L);
    }
    Ls[r] = L;
  }
  __syncthreads();
  const int i = blockIdx.z * NT + tid;
  if (i >= rep * HD) return;
  const int r = i / HD;
  const float* acc = part + p0 * rep * HD + i;
  float A = 0.f;
#pragma unroll 8
  for (int z = 0; z < S; ++z)   // an empty split: weight 0, acc 0
    A = fmaf(wsm[2 * (z * rep + r)], acc[(long long)z * rep * HD], A);
  // a row that saw no position has A = L = 0 and gives exactly 0
  out[((long long)b * kvh + g) * rep * HD + i] =
      from_f<T>(A / fmaxf(Ls[r], 1e-20f));
}

// the combine's shared memory at MAX_SPLITS splits and MAX_REP: 197 KB
constexpr int COMBINE_SMEM_MAX = (2 * (MAX_SPLITS + 1) + 1) * MAX_REP * 4;

// Each kernel's shared-memory limit is raised once per device
// (sm90::smem_limit_once), not on every call of the decode loop.
template <typename T, int HD, auto Kern>
cudaError_t launch(int smem, const Params& a, cudaStream_t stream) {
  constexpr auto comb = paged_decode_combine_kernel<T, HD>;
  cudaError_t err = sm90::smem_limit_once<Kern>(smem);
  if (err == cudaSuccess)
    err = sm90::smem_limit_once<comb>(COMBINE_SMEM_MAX);
  if (err != cudaSuccess) return err;
  Kern<<<dim3(a.kvh, a.B, a.n_splits + 1), NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int S = a.n_splits + 1;
  const int csmem = (2 * S + 1) * a.rep * (int)sizeof(float);
  comb<<<dim3(a.kvh, a.B, (a.rep * HD + NT - 1) / NT), NT, csmem, stream>>>(
      a.part, (T*)a.out, a.B, a.kvh, a.rep, S);
  return cudaGetLastError();
}

template <typename T, int HD, int R>
cudaError_t launch_split(const Params& a, cudaStream_t stream) {
  constexpr int smem = Tiles<T, HD>::KV_BYTES +
                       (R * HD + NWARP * ROWS * R + MAX_PPS) * 4;
  return launch<T, HD, paged_decode_split_kernel<T, HD, R>>(smem, a, stream);
}

template <typename T, int HD>
cudaError_t launch_rep(const Params& a, cudaStream_t stream) {
  if (a.rep <= 4) return launch_split<T, HD, 4>(a, stream);
  if (a.rep <= 8) return launch_split<T, HD, 8>(a, stream);
  return launch_split<T, HD, 16>(a, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. All tensors contiguous, ck/cv/nk/nv
// 16-byte aligned: q/out [B, kvh, rep, hd]; ck/cv [P, page_size, kvh, hd];
// nk/nv [B, K, kvh, hd]; bt [B, n_pages] int32; ctx_len/new_len [B] int32;
// part f32 [B * kvh * (n_splits + 1) * rep * (hd + 2)], the workspace.
// pages_per_split * n_splits must cover n_pages. Two launches on `stream`
// (splits, then combine); returns cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* ck, const void* cv,
                            const void* nk, const void* nv, const void* bt,
                            const void* ctx_len, const void* new_len,
                            void* part, void* out, int B, int kvh, int rep,
                            int hd, int P, int page_size, int n_pages, int K,
                            int pages_per_split, int n_splits, float scale,
                            int dtype, void* stream) {
  if (rep < 1 || rep > MAX_REP || page_size < 1 || pages_per_split < 1 ||
      pages_per_split > MAX_PPS || n_splits < 1 || n_splits > MAX_SPLITS ||
      B > 65535 || (long long)pages_per_split * n_splits < n_pages)
    return (int)cudaErrorInvalidValue;
  const Params a{q, ck, cv, nk, nv, (const int*)bt, (const int*)ctx_len,
                 (const int*)new_len, (float*)part, out, B, kvh, rep, P,
                 page_size, n_pages, K, pages_per_split, n_splits, scale};
  cudaStream_t s = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (dtype == 0) switch (hd) {
    case 16: return launch_rep<float, 16>(a, s);
    case 32: return launch_rep<float, 32>(a, s);
    case 64: return launch_rep<float, 64>(a, s);
    case 128: return launch_rep<float, 128>(a, s);
  }
  if (dtype == 1) switch (hd) {
    case 16: return launch_rep<bf16, 16>(a, s);
    case 32: return launch_rep<bf16, 32>(a, s);
    case 64: return launch_rep<bf16, 64>(a, s);
    case 128: return launch_rep<bf16, 128>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}
