// Out-of-sample query kernel for Hopper (sm_90a), plain C interface.
//
// B5: replaces the TPU's Pallas kernel _query_leaf_kernel
// (pypardis_tpu/ops/pallas_kernels.py, entry query_min_core_pallas).
// For every row of every query tile i it keeps the lexicographic minimum
// of (d2, label) over all C slots of leaf tile_leaf[i]'s core slab, where
// d2 = sum over axes a, in index order, of (q_a - c_a)^2, and returns the
// packed (2, nqt, qb) int32 result [labels, bits(d2)].  Pad slots hold
// 2e19 coordinates (PAD_COORD) and INT32_MAX labels; pad query rows hold
// PAD_COORD in every axis; pad tiles are all pad rows and point at leaf 0.
//
// Bound.  The answer needs, per real row, its leaf's core slots: 3d FP32
// operations (sub, mul, add per axis) and a compare per pair.  The
// squares are sealed (__fsub_rn/__fmul_rn/__fadd_rn, never contracted to
// an FMA, never built with --use_fast_math), so each operation is one
// instruction and the SIMT ceiling is twice the FP32-peak bound.  Bytes
// (each query row, each referenced slab once) are far below.
//
// What the first form computed instead: every row of every
// tile, pad rows and pad tiles included, against every slot of the slab,
// its pad tail included.  At the 1M x 16-D index (leaf_cap 31,232, 64
// leaves of about half that, nqt 256 for 167 real tiles) only 24.9 % of
// the launched (row, slot) pairs were real.  This design computes none
// of the padding, and the result stays bitwise the plain version
// (ops/query.query_min_core_plain) on every row:
//
// * Pad rows need no pass.  Against a pad row the plain version's answer
//   depends on the leaf alone; pp_query_tables computes it once per index
//   (query_tables_kernel: the pad row's key over the whole slab, with the
//   pass's own arithmetic).  query_rows_kernel, the first launch of a
//   call, classifies each row by its bits (pad: PAD_COORD in every axis)
//   and writes the pad rows' keys; a 32-row group of pad rows, and so a
//   pad tile, runs nothing else.
// * The pad tail is skipped.  leaf_end[l] is one past the last slot of
//   leaf l that is not a pad slot (label INT32_MAX and PAD_COORD in every
//   axis).  Against a row with some |q_a| < 1e18 a pad slot's d2
//   overflows to +inf, and its key (+inf, INT32_MAX) is the starting key:
//   it can never change the minimum.  A group holding a real row whose
//   every |q_a| >= 1e18 visits the whole slab.
// * The pass (query_pass_kernel): grid (tile, column span, 128-row slab),
//   4 warps.  At d <= 32 a warp takes two 32-row groups over half the
//   span, two rows per thread, so that one staged column feeds both and
//   their sums interleave (3 % faster than one row per thread over the
//   whole span, H100); at d = 64 one group and one row (its coordinates
//   fill the registers); past 64 axes the rows are read from global
//   memory.  A block stages its span of the slab once (point-major, for
//   float4 broadcast reads; one barrier) and exits at once where no
//   group of it reaches the span.  Each thread keeps its rows' best (d2,
//   label) and adds each to its row's 64-bit key (bits(d2) << 32) |
//   (label ^ 2^31) with atomicMin: d2 >= 0 is never NaN, so its bits
//   order as an unsigned integer (+inf included), and the flipped sign
//   bit orders labels as signed integers, so the least key is the
//   lexicographic least (d2, label) whatever the order of the atomics.
//   query_unpack_kernel writes [labels, bits] (a row no pass touched
//   takes the starting key (+inf, INT32_MAX), the plain version's answer
//   against a slab it cannot reach).  An optional counter takes the
//   (row, slot) pairs the pass computes, 32 per row group and column it
//   runs; chip_smoke.py holds it equal to ops/query.query_pass_pairs, so
//   the real share of the computed pairs is measured on the card.
//
// "mixed" (the TPU kernel's _fast_block_keep prefilter) runs in two
// phases: a prefilter launch sets a keep flag per unit (tile, 32-row
// group, column block), then the pass runs the kept units only.  The
// per-index block frames (query_frames_kernel, once per index: each
// column block's box midpoint c over its real slots, and per slot
// |y - c|^2, |y - c|, |y| and its real flag, label != INT32_MAX) replace
// the first form's per-chunk recomputation and its five barriers per
// chunk.  A unit is kept iff some pair of a real query row (every |q_a|
// < 1e18) and a real slot has d2f - band <= eps2: d2f from mma.sync
// m16n8k16 on bf16 (q - c) . (y - c) (bf16_tile.cuh), band the
// per-element bt_band at |q - c|, |y - c| and |q|, |y|.  Pad rows and pad
// slots are excluded by these flags, never by the inf/NaN arithmetic of
// their 2e19 coordinates.  d2f - band lower-bounds the exact d2, so a
// unit that could hold a core within eps of a row is always kept: a row
// with a core within eps gets the exact answer; a row without one may
// keep +inf.  At d <= 64 query_keep_staged_kernel stages the block's
// bf16 operands and frames 64 columns at a time and stops after the
// chunk where every warp decided (most kept units decide in their first;
// the first form's operands read from global memory ran mixed B5 at 1.7
// ms per batch against 0.97 ms staged, H100); past 64 axes
// query_keep_global_kernel reads them from global memory.  Optional
// counters take [kept, visited] units (visited: a group with a real row,
// a block below the leaf's end).
//
// Measured (chip_smoke.py --b5, NVIDIA H100 80GB HBM3, 700 W, 1M x 16-D,
// 4,096-query batches): the pass 0.63 ms of device time per batch
// against a 0.19 ms bound and a 0.37 ms unfused SIMT ceiling (by the
// source about 56 instructions per launched pair against the bound's
// 49), the staged prefilter 0.19 ms; pad rows and the unpack 5 us.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"

#define PQ_THREADS 128       // 4 warps: the 4 groups of a 128-row slab
#define PQ_GROUPS 4
#define PQ_SPAN_BYTES 16384  // staged coordinates per pass block
#define PQ_MAX_SPAN 512
#define PQ_TABLE_THREADS 256
#define PQ_NCOL 64           // columns per prefilter mma group: 8 n-tiles
#define PQ_KEEP_COLS 2048    // slab columns per prefilter warp

#define PQ_PAD_BITS 0x5f8ac723u  // PAD_COORD = 2e19 as float32
#define PQ_PAD_LIMIT 1e18f
// Row classes of query_rows_kernel, per 32-row group.
#define PQ_REAL 1  // a row that is not a pad row
#define PQ_NEAR 2  // a real row with every |q_a| >= 1e18
#define PQ_QREAL 4  // a row with every |q_a| < 1e18 (the prefilter's)
#define PQ_KEEP_CHUNK 64  // columns a prefilter block stages at a time

typedef unsigned long long u64;

// The starting key (+inf, INT32_MAX).
#define PQ_INIT_KEY 0x7f800000ffffffffull

__device__ __forceinline__ u64 pq_key(float d2, int label) {
  return ((u64)__float_as_uint(d2) << 32) |
         (u64)((unsigned int)label ^ 0x80000000u);
}

// One slot's sealed d2 against a row held in registers (DC > 0) or in
// global memory (DC == 0), axes in index order.  Padded axes (d <= a <
// dp) hold 0 on both sides and add +0, which leaves d2 unchanged.
// FULL: d fills DC's float4s (no padded float4 to skip).
template <int DC, bool FULL>
__device__ __forceinline__ float pq_d2(const float* xr, const float* y,
                                       const float* qrow, int qb, int d) {
  float d2 = 0.f;
  if (DC > 0) {
#pragma unroll
    for (int k = 0; k < (DC > 0 ? DC : 4) / 4; ++k) {
      if (FULL || 4 * k < d) {
        const float4 y4 = reinterpret_cast<const float4*>(y)[k];
        float df = __fsub_rn(xr[4 * k + 0], y4.x);
        d2 = __fadd_rn(d2, __fmul_rn(df, df));
        df = __fsub_rn(xr[4 * k + 1], y4.y);
        d2 = __fadd_rn(d2, __fmul_rn(df, df));
        df = __fsub_rn(xr[4 * k + 2], y4.z);
        d2 = __fadd_rn(d2, __fmul_rn(df, df));
        df = __fsub_rn(xr[4 * k + 3], y4.w);
        d2 = __fadd_rn(d2, __fmul_rn(df, df));
      }
    }
  } else {
    for (int a = 0; a < d; ++a) {
      const float df = __fsub_rn(__ldg(qrow + (size_t)a * qb), y[a]);
      d2 = __fadd_rn(d2, __fmul_rn(df, df));
    }
  }
  return d2;
}

// -- per-index tables ----------------------------------------------------

// One block per leaf: leaf_end (one past the last slot that is not a pad
// slot) and the pad row's key over the whole slab.
__global__ void __launch_bounds__(PQ_TABLE_THREADS) query_tables_kernel(
    const float* __restrict__ coords, const int* __restrict__ labels,
    long long ncols, int d, int C, u64* __restrict__ pad_keys,
    int* __restrict__ leaf_end) {
  __shared__ u64 sk[PQ_TABLE_THREADS / 32];
  __shared__ int se[PQ_TABLE_THREADS / 32];
  const long long base = (long long)blockIdx.x * C;
  const float pad = __uint_as_float(PQ_PAD_BITS);
  u64 best = PQ_INIT_KEY;
  int end = 0;
  for (int j = threadIdx.x; j < C; j += blockDim.x) {
    float d2 = 0.f;
    bool pad_axes = true;
    for (int a = 0; a < d; ++a) {
      const float y = coords[(size_t)a * ncols + base + j];
      pad_axes = pad_axes && __float_as_uint(y) == PQ_PAD_BITS;
      const float df = __fsub_rn(pad, y);
      d2 = __fadd_rn(d2, __fmul_rn(df, df));
    }
    const int lab = labels[base + j];
    if (!(pad_axes && lab == 0x7fffffff)) end = j + 1;
    const u64 k = pq_key(d2, lab);
    best = k < best ? k : best;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 k = __shfl_xor_sync(0xffffffffu, best, o);
    best = k < best ? k : best;
    end = max(end, __shfl_xor_sync(0xffffffffu, end, o));
  }
  if ((threadIdx.x & 31) == 0) {
    sk[threadIdx.x >> 5] = best;
    se[threadIdx.x >> 5] = end;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      best = sk[w] < best ? sk[w] : best;
      end = max(end, se[w]);
    }
    pad_keys[blockIdx.x] = best;
    leaf_end[blockIdx.x] = end;
  }
}

// One block per column block of the slab: the box midpoint of its real
// slots (0 without one), then per slot [|y-c|^2, |y-c|, |y|, real].
__global__ void __launch_bounds__(PQ_TABLE_THREADS) query_frames_kernel(
    const float* __restrict__ coords, const int* __restrict__ labels,
    long long ncols, int d, int block, float* __restrict__ ctr,
    float4* __restrict__ slots) {
  const long long base = (long long)blockIdx.x * block;
  float* c = ctr + (size_t)blockIdx.x * d;
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int a = threadIdx.x >> 5; a < d; a += nw) {
    float lo = __int_as_float(0x7f800000), hi = -lo;
    for (int t = lane; t < block; t += 32) {
      if (labels[base + t] == 0x7fffffff) continue;
      const float v = coords[(size_t)a * ncols + base + t];
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0)
      c[a] = hi >= lo ? __fmul_rn(0.5f, __fadd_rn(hi, lo)) : 0.f;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < block; t += blockDim.x) {
    const bool real = labels[base + t] != 0x7fffffff;
    float s1 = 0.f, s2 = 0.f;
    if (real) {
      for (int a = 0; a < d; ++a) {
        const float y = coords[(size_t)a * ncols + base + t];
        const float df = __fsub_rn(y, c[a]);
        s1 = __fadd_rn(s1, __fmul_rn(df, df));
        s2 = __fadd_rn(s2, __fmul_rn(y, y));
      }
    }
    slots[base + t] =
        make_float4(s1, __fsqrt_rn(s1), __fsqrt_rn(s2), real ? 1.f : 0.f);
  }
}

// -- per call ------------------------------------------------------------

// Grid (nqt, ceil(G / 4)), 4 warps of one 32-row group each: each row's
// class; a pad row's key from the table, every other row's starting key
// all ones (the unpack takes the least of it and (+inf, INT32_MAX)).
__global__ void __launch_bounds__(PQ_THREADS) query_rows_kernel(
    const float* __restrict__ q, const int* __restrict__ tile_leaf, int d,
    int qb, int G, const u64* __restrict__ pad_keys,
    unsigned char* __restrict__ grp, u64* __restrict__ keys) {
  const int tile = blockIdx.x;
  const int group = blockIdx.y * PQ_GROUPS + (threadIdx.x >> 5);
  if (group >= G) return;
  const int row = group * 32 + (threadIdx.x & 31);
  const bool active = row < qb;
  const float* qt = q + (size_t)tile * d * qb + (active ? row : 0);
  bool pad = true, near = true, small = true;
  for (int a = 0; a < d; ++a) {
    const float v = qt[(size_t)a * qb];
    pad = pad && __float_as_uint(v) == PQ_PAD_BITS;
    near = near && !(fabsf(v) < PQ_PAD_LIMIT);
    small = small && fabsf(v) < PQ_PAD_LIMIT;
  }
  const bool real = active && !pad;
  const unsigned rb = __ballot_sync(0xffffffffu, real);
  const unsigned nb = __ballot_sync(0xffffffffu, real && near);
  const unsigned sb = __ballot_sync(0xffffffffu, active && small);
  if ((threadIdx.x & 31) == 0)
    grp[(size_t)tile * G + group] = (unsigned char)(
        (rb ? PQ_REAL : 0) | (nb ? PQ_NEAR : 0) | (sb ? PQ_QREAL : 0));
  if (active)
    keys[(size_t)tile * qb + row] =
        pad ? pad_keys[tile_leaf[tile]] : ~0ull;
}

// The last columns a group must visit: none without a real row, the
// whole slab with a row near the pad magnitude, else the leaf's end.
__device__ __forceinline__ int pq_group_limit(unsigned char info, int end,
                                              int C) {
  return (info & PQ_REAL) ? ((info & PQ_NEAR) ? C : end) : 0;
}

// Rows per thread of the pass: two at d <= 32, so that one staged column
// feeds both and their sums interleave; one where 2 x 64 coordinates
// would not fit the registers, or past 64 axes.
template <int DC>
struct PqRows {
  static constexpr int R = (DC > 0 && DC <= 32) ? 2 : 1;
};

__device__ __forceinline__ void pq_take(float d2, int v, float& bd,
                                        int& bl) {
  if (d2 <= bd && (d2 < bd || v < bl)) {
    bd = d2;
    bl = v;
  }
}

// Columns [t0, t1) of the staged span against the thread's rows (A0: its
// first, A1: its second).
template <int DC, bool FULL, bool A0, bool A1>
__device__ __forceinline__ void pq_run(const float* xr0, const float* xr1,
                                       const float* ys, const int* sv,
                                       int dp, int t0, int t1,
                                       const float* qrow0, const float* qrow1,
                                       int qb, int d, float* bd, int* bl) {
  for (int t = t0; t < t1; ++t) {
    const float* y = ys + (size_t)t * dp;
    const int v = sv[t];
    if (A0) pq_take(pq_d2<DC, FULL>(xr0, y, qrow0, qb, d), v, bd[0], bl[0]);
    if (A1) pq_take(pq_d2<DC, FULL>(xr1, y, qrow1, qb, d), v, bd[1], bl[1]);
  }
}

template <int DC, bool FULL>
__global__ void __launch_bounds__(PQ_THREADS) query_pass_kernel(
    const float* __restrict__ q, const int* __restrict__ tile_leaf,
    const float* __restrict__ coords, const int* __restrict__ labels,
    long long ncols, int d, int qb, int C, int G, int span, int block,
    int nb, const int* __restrict__ leaf_end,
    const unsigned char* __restrict__ grp,
    const unsigned char* __restrict__ flags, u64* __restrict__ keys,
    u64* __restrict__ pass_stats) {
  constexpr int R = PqRows<DC>::R;
  constexpr int NP = PQ_GROUPS / R;  // warps over the slab's rows
  extern __shared__ float4 smem4[];
  const int dp = (d + 3) & ~3;
  float* ys = reinterpret_cast<float*>(smem4);
  int* sv = reinterpret_cast<int*>(ys + (size_t)span * dp);

  const int tile = blockIdx.x;
  const int j0 = blockIdx.y * span;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int leaf = tile_leaf[tile];
  const int end = leaf_end[leaf];
  // Warp w takes the groups p * R .. p * R + R - 1 (p = w % NP) over the
  // part w / NP of the span's columns.  Every thread reads the slab's
  // four group classes, so the block's decisions need no barrier.
  const int part = warp / NP;
  int lim = 0, wl[R];
#pragma unroll
  for (int r = 0; r < R; ++r) wl[r] = 0;
#pragma unroll
  for (int w = 0; w < PQ_GROUPS; ++w) {
    const int g = blockIdx.z * PQ_GROUPS + w;
    const int l = g < G ? pq_group_limit(grp[(size_t)tile * G + g], end, C)
                        : 0;
    lim = max(lim, l);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (w == (warp % NP) * R + r) wl[r] = l;
  }
  if (j0 >= lim) return;
  const int j1 = min(j0 + span, lim);
  const int plo = j0 + part * (span / R);
  const int phi = min(j1, R == 1 ? j1 : j0 + (part + 1) * (span / R));
  const int group0 = blockIdx.z * PQ_GROUPS + (warp % NP) * R;
  // "mixed": run a group's block only where the prefilter kept it.
  const unsigned char* gflags =
      flags ? flags + ((size_t)tile * G + group0) * nb : nullptr;
  if (flags) {
    bool any = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int hi = min(phi, wl[r]);
      if (plo < hi) {
        for (int b = plo / block + lane; b <= (hi - 1) / block; b += 32)
          any = any || gflags[(size_t)r * nb + b];
      }
    }
    any = __any_sync(0xffffffffu, any);
    if (!__syncthreads_or(any)) return;
  }

  const long long base = (long long)leaf * C;
  const int w = j1 - j0;
  for (int t = threadIdx.x; t < w; t += blockDim.x) {
    sv[t] = labels[base + j0 + t];
    const float* src = coords + base + j0 + t;
    float4* dst = reinterpret_cast<float4*>(ys + (size_t)t * dp);
    for (int a = 0; a < dp; a += 4) {
      float4 v;
      v.x = a < d ? src[(size_t)a * ncols] : 0.f;
      v.y = a + 1 < d ? src[(size_t)(a + 1) * ncols] : 0.f;
      v.z = a + 2 < d ? src[(size_t)(a + 2) * ncols] : 0.f;
      v.w = a + 3 < d ? src[(size_t)(a + 3) * ncols] : 0.f;
      dst[a >> 2] = v;
    }
  }
  __syncthreads();
  int whi = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) whi = max(whi, min(phi, wl[r]));
  if (plo >= whi) return;

  // The thread's rows: row r is lane of group group0 + r.
  const float* qt = q + (size_t)tile * d * qb;
  const float* qrow[R];
  bool live[R];
  float xr[R][DC > 0 ? DC : 1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = (group0 + r) * 32 + lane;
    live[r] = row < qb;
    qrow[r] = qt + (live[r] ? row : 0);
    bool pad = true;
    if (DC > 0) {
#pragma unroll
      for (int a = 0; a < (DC > 0 ? DC : 1); ++a) {
        xr[r][a] = a < d ? qrow[r][(size_t)a * qb] : 0.f;
        if (a < d) pad = pad && __float_as_uint(xr[r][a]) == PQ_PAD_BITS;
      }
    } else {
      for (int a = 0; a < d; ++a)
        pad = pad && __float_as_uint(qrow[r][(size_t)a * qb]) == PQ_PAD_BITS;
    }
    live[r] = live[r] && !pad;
  }

  float bd[2] = {__int_as_float(0x7f800000), __int_as_float(0x7f800000)};
  int bl[2] = {0x7fffffff, 0x7fffffff};
  const float* xr1 = xr[R - 1];
  const float* q1 = qrow[R - 1];
  u64 pairs = 0;  // (row, slot) pairs computed: 32 per group and column
  int s = plo;
  while (s < whi) {
    // One segment: its rows stay the same up to its end (a group's
    // limit, the end of a column block under "mixed", the part's end).
    int e = whi;
    bool on[2] = {false, false};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      on[r] = s < wl[r];
      if (on[r]) e = min(e, wl[r]);
    }
    if (flags) {
      const int b = s / block;
      e = min(e, (b + 1) * block);
#pragma unroll
      for (int r = 0; r < R; ++r)
        on[r] = on[r] && gflags[(size_t)r * nb + b];
    }
    const int t0 = s - j0, t1 = e - j0;
    pairs += (u64)(t1 - t0) * 32u * (unsigned)(on[0] + on[1]);
    if (R == 2 && on[0] && on[1])
      pq_run<DC, FULL, true, true>(xr[0], xr1, ys, sv, dp, t0, t1, qrow[0],
                                   q1, qb, d, bd, bl);
    else if (on[0])
      pq_run<DC, FULL, true, false>(xr[0], xr1, ys, sv, dp, t0, t1, qrow[0],
                                    q1, qb, d, bd, bl);
    else if (R == 2 && on[1])
      pq_run<DC, FULL, false, true>(xr[0], xr1, ys, sv, dp, t0, t1, qrow[0],
                                    q1, qb, d, bd, bl);
    s = e;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (live[r] &&
        (bl[r] != 0x7fffffff || bd[r] != __int_as_float(0x7f800000)))
      atomicMin(keys + (size_t)tile * qb + (group0 + r) * 32 + lane,
                pq_key(bd[r], bl[r]));
  }
  if (pass_stats && lane == 0 && pairs) atomicAdd(pass_stats, pairs);
}

// "mixed" past 64 axes, where a staged column block would not fit shared
// memory: grid (nqt, column ranges of PQ_KEEP_COLS, 128-row slabs), one
// warp per 32-row group, the rows and columns read from global memory;
// sets flags[(tile * G + group) * nb + b] for each kept unit (the caller
// zeroed them).
__global__ void __launch_bounds__(PQ_THREADS) query_keep_global_kernel(
    const float* __restrict__ q, const int* __restrict__ tile_leaf,
    const float* __restrict__ coords, long long ncols, int d, int qb,
    int C, int G, int block, int nb, int bper,
    const int* __restrict__ leaf_end, const float* __restrict__ ctr,
    const float4* __restrict__ slots, float eps2,
    unsigned char* __restrict__ flags, u64* __restrict__ keep_stats) {
  const int tile = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int group = blockIdx.z * PQ_GROUPS + warp;
  if (group >= G) return;
  const int leaf = tile_leaf[tile];
  const int nbend = (leaf_end[leaf] + block - 1) / block;
  const int b0 = blockIdx.y * bper;
  const int b1 = min(b0 + bper, nbend);
  if (b0 >= b1) return;
  const int wrow0 = group * 32;
  const int row = wrow0 + lane;
  const float* qt = q + (size_t)tile * d * qb;
  const float* qrow = qt + (row < qb ? row : 0);

  // This row's index-frame norm and whether it is real.
  bool qreal = row < qb;
  float s2 = 0.f;
  for (int a = 0; a < d; ++a) {
    const float v = qrow[(size_t)a * qb];
    qreal = qreal && fabsf(v) < PQ_PAD_LIMIT;
    s2 = __fadd_rn(s2, __fmul_rn(v, v));
  }
  if (!__any_sync(0xffffffffu, qreal)) return;
  const float gq = __fsqrt_rn(s2);
  float rgq[2][2];
  bool rre[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int src = mt * 16 + h * 8 + g;
      rgq[mt][h] = __shfl_sync(0xffffffffu, gq, src);
      rre[mt][h] = __shfl_sync(0xffffffffu, (int)qreal, src) != 0;
    }

  const long long base = (long long)leaf * C;
  unsigned kept = 0;
  for (int b = b0; b < b1; ++b) {
    const float* c = ctr + ((size_t)leaf * nb + b) * d;
    // This row's recentred norm, then the four fragment rows' values.
    float xx = 0.f;
    for (int a = 0; a < d; ++a) {
      const float df = __fsub_rn(qrow[(size_t)a * qb], __ldg(c + a));
      xx = __fadd_rn(xx, __fmul_rn(df, df));
    }
    float rxx[2][2], rnq[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rxx[mt][h] = __shfl_sync(0xffffffffu, xx, mt * 16 + h * 8 + g);
        rnq[mt][h] = __fsqrt_rn(rxx[mt][h]);
      }
    const long long cb = base + (long long)b * block;
    bool keep = false;
    for (int c0 = 0; c0 < block && !keep; c0 += PQ_NCOL) {
      float acc[2][PQ_NCOL / 8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < PQ_NCOL / 8; ++j)
          acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] =
              0.f;
      for (int k0 = 0; k0 < d; k0 += 16) {
        unsigned af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int a = k0 + t4 * 2 + (i & 1) + (i >> 2) * 8;
            const int rr = wrow0 + mt * 16 + g + ((i >> 1) & 1) * 8;
            v[i] = (a < d && rr < qb)
                       ? __fsub_rn(qt[(size_t)a * qb + rr], __ldg(c + a))
                       : 0.f;
          }
          af[mt][0] = bt_pack(v[0], v[1]);
          af[mt][1] = bt_pack(v[2], v[3]);
          af[mt][2] = bt_pack(v[4], v[5]);
          af[mt][3] = bt_pack(v[6], v[7]);
        }
#pragma unroll
        for (int j = 0; j < PQ_NCOL / 8; ++j) {
          const int col = c0 + j * 8 + g;
          float v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int a = k0 + t4 * 2 + (i & 1) + (i >> 1) * 8;
            v[i] = (a < d && col < block)
                       ? __fsub_rn(__ldg(coords + (size_t)a * ncols + cb +
                                         col),
                                   __ldg(c + a))
                       : 0.f;
          }
          const unsigned bf[2] = {bt_pack(v[0], v[1]), bt_pack(v[2], v[3])};
          bt_mma(acc[0][j], af[0], bf);
          bt_mma(acc[1][j], af[1], bf);
        }
      }
#pragma unroll
      for (int j = 0; j < PQ_NCOL / 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int col = c0 + j * 8 + t4 * 2 + e2;
          if (col >= block) continue;
          const float4 f = __ldg(slots + cb + col);  // [cc, nc, gc, real]
          if (f.w == 0.f) continue;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              if (!rre[mt][h]) continue;
              const float d2f =
                  bt_d2f(rxx[mt][h], f.x, acc[mt][j][h * 2 + e2]);
              const float band = bt_band(rnq[mt][h], f.y, rgq[mt][h], f.z);
              keep = keep || __fsub_rn(d2f, band) <= eps2;
            }
        }
      keep = __any_sync(0xffffffffu, keep);
    }
    if (keep) {
      ++kept;
      if (lane == 0) flags[((size_t)tile * G + group) * nb + b] = 1;
    }
  }
  if (keep_stats && lane == 0) {
    atomicAdd(keep_stats, (u64)kept);
    atomicAdd(keep_stats + 1, (u64)(b1 - b0));
  }
}

// "mixed" at d <= 64: grid (nqt, nb, 128-row slabs), one block per
// column block of a tile, one warp per 32-row group.  The block stages
// the column block's bf16 (y - c) pairs (padded rows of BST words: no
// bank conflicts on the B fragments' reads) and its slot frames,
// PQ_KEEP_CHUNK columns at a time, and stops after the chunk where every
// warp has decided: a warp decides at its first chunk that keeps, and
// most kept units keep in their first.  Sets flags[(tile * G + group) *
// nb + b] for a kept unit (the caller zeroed them).  Six blocks per SM:
// measured faster than four despite the spills this bound costs.
template <int DC>
__global__ void __launch_bounds__(PQ_THREADS, 6) query_keep_staged_kernel(
    const float* __restrict__ q, const int* __restrict__ tile_leaf,
    const float* __restrict__ coords, long long ncols, int d, int qb,
    int C, int G, int block, int nb, const int* __restrict__ leaf_end,
    const unsigned char* __restrict__ grp, const float* __restrict__ ctr,
    const float4* __restrict__ slots, float eps2,
    unsigned char* __restrict__ flags, u64* __restrict__ keep_stats) {
  constexpr int KP = (DC + 15) / 16 * 8;  // bf16 pairs per column
  constexpr int KS = KP / 8;              // mma k-steps
  constexpr int BST = KP + 4;             // words per staged column
  extern __shared__ float4 smem4[];
  float4* fs = smem4;
  unsigned* bs = reinterpret_cast<unsigned*>(fs + PQ_KEEP_CHUNK);
  float* cs = reinterpret_cast<float*>(bs + PQ_KEEP_CHUNK * BST);

  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const int leaf = tile_leaf[tile];
  if (b * block >= leaf_end[leaf]) return;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int group = blockIdx.z * PQ_GROUPS + warp;
  const bool mine = group < G && (grp[(size_t)tile * G + group] & PQ_QREAL);
  if (!__syncthreads_or(mine)) return;
  const float* c = ctr + ((size_t)leaf * nb + b) * d;
  for (int a = threadIdx.x; a < DC; a += blockDim.x)
    cs[a] = a < d ? c[a] : 0.f;
  __syncthreads();

  // This row's realness, index-frame and recentred norms, then the four
  // fragment rows' values and the A fragments of every k-step.
  const int wrow0 = group * 32;
  const int row = wrow0 + lane;
  const float* qt = q + (size_t)tile * d * qb;
  float rxx[2][2], rnq[2][2], rgq[2][2];
  bool rre[2][2];
  unsigned af[KS][2][4];
  if (mine) {
    const float* qrow = qt + (row < qb ? row : 0);
    bool qreal = row < qb;
    float s2 = 0.f, xx = 0.f;
    for (int a = 0; a < d; ++a) {
      const float v = qrow[(size_t)a * qb];
      qreal = qreal && fabsf(v) < PQ_PAD_LIMIT;
      s2 = __fadd_rn(s2, __fmul_rn(v, v));
      const float df = __fsub_rn(v, cs[a]);
      xx = __fadd_rn(xx, __fmul_rn(df, df));
    }
    const float gq = __fsqrt_rn(s2);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int src = mt * 16 + h * 8 + g;
        rxx[mt][h] = __shfl_sync(0xffffffffu, xx, src);
        rnq[mt][h] = __fsqrt_rn(rxx[mt][h]);
        rgq[mt][h] = __shfl_sync(0xffffffffu, gq, src);
        rre[mt][h] = __shfl_sync(0xffffffffu, (int)qreal, src) != 0;
      }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int a = ks * 16 + t4 * 2 + (i & 1) + (i >> 2) * 8;
          const int rr = wrow0 + mt * 16 + g + ((i >> 1) & 1) * 8;
          v[i] = (a < d && rr < qb) ? __fsub_rn(qt[(size_t)a * qb + rr], cs[a])
                                    : 0.f;
        }
        af[ks][mt][0] = bt_pack(v[0], v[1]);
        af[ks][mt][1] = bt_pack(v[2], v[3]);
        af[ks][mt][2] = bt_pack(v[4], v[5]);
        af[ks][mt][3] = bt_pack(v[6], v[7]);
      }
  }

  const long long base = (long long)leaf * C + (long long)b * block;
  bool keep = false, done = !mine;
  for (int j0 = 0; j0 < block; j0 += PQ_KEEP_CHUNK) {
    // Every warp has decided, or the previous chunk is consumed.
    if (!__syncthreads_or(!done)) break;
    const int w = min(PQ_KEEP_CHUNK, block - j0);
    for (int t = threadIdx.x; t < w; t += blockDim.x)
      fs[t] = slots[base + j0 + t];
    for (int kp = 0; kp < KP; ++kp) {
      const int a = 2 * kp;
      for (int t = threadIdx.x; t < w; t += blockDim.x) {
        const float* y = coords + base + j0 + t;
        const float v0 = a < d ? __fsub_rn(y[(size_t)a * ncols], cs[a]) : 0.f;
        const float v1 =
            a + 1 < d ? __fsub_rn(y[(size_t)(a + 1) * ncols], cs[a + 1]) : 0.f;
        bs[t * BST + kp] = bt_pack(v0, v1);
      }
    }
    __syncthreads();
    for (int c0 = 0; c0 < w && !done; c0 += PQ_NCOL) {
      float acc[2][PQ_NCOL / 8][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int j = 0; j < PQ_NCOL / 8; ++j)
          acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] =
              0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int j = 0; j < PQ_NCOL / 8; ++j) {
          // Columns past w hold the previous chunk's or stale words;
          // the epilogue never reads their results.
          const unsigned* bc = bs + (c0 + j * 8 + g) * BST + ks * 8 + t4;
          const unsigned bf[2] = {bc[0], bc[4]};
          bt_mma(acc[0][j], af[ks][0], bf);
          bt_mma(acc[1][j], af[ks][1], bf);
        }
      // First d2f alone: band >= 0, so fl(d2f - band) <= d2f, and a pair
      // with d2f <= eps2 keeps the unit by the rule without its band.
#pragma unroll
      for (int j = 0; j < PQ_NCOL / 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int col = c0 + j * 8 + t4 * 2 + e2;
          if (col >= w) continue;
          const float4 f = fs[col];  // [cc, nc, gc, real]
          if (f.w == 0.f) continue;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              keep = keep || (rre[mt][h] && bt_d2f(rxx[mt][h], f.x,
                                                   acc[mt][j][h * 2 + e2]) <=
                                                eps2);
        }
      keep = __any_sync(0xffffffffu, keep);
      if (!keep) {
#pragma unroll
        for (int j = 0; j < PQ_NCOL / 8; ++j)
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int col = c0 + j * 8 + t4 * 2 + e2;
            if (col >= w) continue;
            const float4 f = fs[col];
            if (f.w == 0.f) continue;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                if (!rre[mt][h]) continue;
                const float d2f =
                    bt_d2f(rxx[mt][h], f.x, acc[mt][j][h * 2 + e2]);
                const float band =
                    bt_band(rnq[mt][h], f.y, rgq[mt][h], f.z);
                keep = keep || __fsub_rn(d2f, band) <= eps2;
              }
          }
        keep = __any_sync(0xffffffffu, keep);
      }
      done = keep;
    }
  }
  if (mine && keep && lane == 0)
    flags[((size_t)tile * G + group) * nb + b] = 1;
  if (keep_stats) {
    const int kept = __syncthreads_count(mine && keep && lane == 0);
    const int seen = __syncthreads_count(mine && lane == 0);
    if (threadIdx.x == 0) {
      atomicAdd(keep_stats, (u64)kept);
      atomicAdd(keep_stats + 1, (u64)seen);
    }
  }
}

// Least of each row's key and the starting key, unpacked into [labels,
// bits(d2)].
__global__ void query_unpack_kernel(const u64* __restrict__ keys,
                                    long long nrows, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nrows) return;
  u64 k = keys[i];
  k = k < PQ_INIT_KEY ? k : PQ_INIT_KEY;
  out[i] = (int)((unsigned int)(k & 0xffffffffu) ^ 0x80000000u);
  out[nrows + i] = (int)(unsigned int)(k >> 32);
}

// Columns a pass block stages: about PQ_SPAN_BYTES of coordinates, a
// whole number of warps' worth where that many fit.
static int pq_span(int d) {
  const int dp = (d + 3) & ~3;
  int span = PQ_SPAN_BYTES / (4 * dp);
  if (span >= 32) span = span / 32 * 32;
  if (span > PQ_MAX_SPAN) span = PQ_MAX_SPAN;
  return span < 1 ? 1 : span;
}

template <int DC>
static int launch_dc(int mixed, dim3 pgrid, dim3 kgrid, size_t smem,
                     cudaStream_t s, const float* q, const int* tile_leaf,
                     const float* coords, const int* labels, long long ncols,
                     int d, int qb, int C, int G, int span, int block, int nb,
                     int bper, const int* leaf_end, const float* ctr,
                     const float4* slots, float eps2, unsigned char* grp,
                     unsigned char* flags, u64* keep_stats, u64* pass_stats,
                     u64* keys) {
  const bool full = DC > 0 && ((d + 3) & ~3) == DC;
  void (*pass)(const float*, const int*, const float*, const int*,
               long long, int, int, int, int, int, int, int, const int*,
               const unsigned char*, const unsigned char*, u64*, u64*) =
      full ? query_pass_kernel<DC, true> : query_pass_kernel<DC, false>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        pass, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (mixed) {
    if constexpr (DC > 0) {
      constexpr int BST = (DC + 15) / 16 * 8 + 4;
      const size_t ksmem = (size_t)PQ_KEEP_CHUNK * (16 + 4 * BST) + DC * 4;
      query_keep_staged_kernel<DC><<<dim3(pgrid.x, nb, pgrid.z), PQ_THREADS,
                                     ksmem, s>>>(
          q, tile_leaf, coords, ncols, d, qb, C, G, block, nb, leaf_end, grp,
          ctr, slots, eps2, flags, keep_stats);
    } else {
      query_keep_global_kernel<<<kgrid, PQ_THREADS, 0, s>>>(
          q, tile_leaf, coords, ncols, d, qb, C, G, block, nb, bper,
          leaf_end, ctr, slots, eps2, flags, keep_stats);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  pass<<<pgrid, PQ_THREADS, smem, s>>>(
      q, tile_leaf, coords, labels, ncols, d, qb, C, G, span, block, nb,
      leaf_end, grp, mixed ? flags : nullptr, keys, pass_stats);
  return (int)cudaGetLastError();
}

extern "C" {

// Build the per-index tables of B5: pad_keys (L,) u64, the pad rows'
// keys; leaf_end (L,) int32; and the "mixed" block frames, ctr (L * nb,
// d) float32 and slots (L * C, 4) float32 [|y-c|^2, |y-c|, |y|, real],
// nb = C / block.  coords (d, L * C) float32; labels (L * C,) int32.
// Returns the cudaError_t of the launches.
int pp_query_tables(const float* coords, const int* labels, int L, int C,
                    int block, int d, void* pad_keys, int* leaf_end,
                    float* ctr, float* slots, void* stream) {
  if (L <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const long long ncols = (long long)L * C;
  const long long nb = C / block;
  query_tables_kernel<<<L, PQ_TABLE_THREADS, 0, s>>>(
      coords, labels, ncols, d, C, reinterpret_cast<u64*>(pad_keys),
      leaf_end);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  query_frames_kernel<<<(unsigned)(L * nb), PQ_TABLE_THREADS, 0, s>>>(
      coords, labels, ncols, d, block, ctr,
      reinterpret_cast<float4*>(slots));
  return (int)cudaGetLastError();
}

// B5.  q (nqt, d, qb) float32; tile_leaf (nqt,) int32; coords (d, ncols)
// float32 with ncols = L * C; labels (ncols,) int32; pad_keys, leaf_end,
// ctr and slots from pp_query_tables; eps2 the float32 eps^2 and mixed 1
// for the "mixed" prefilter; keep_stats NULL or two uint64 counters
// [kept, visited] the caller zeroed; pass_stats NULL or one uint64 to
// which the pass adds the (row, slot) pairs it computes (32 per row group
// and column it runs); scratch: keys (nqt * qb u64), grp
// (nqt * G bytes, G = ceil(qb / 32)) and, under "mixed", flags (nqt * G *
// nb bytes); out (2, nqt, qb) int32.  Returns the cudaError_t of the
// launches.
int pp_query_leaf(const float* q, const int* tile_leaf, const float* coords,
                  const int* labels, long long ncols, int nqt, int d, int qb,
                  int C, int block, const void* pad_keys,
                  const int* leaf_end, const float* ctr, const float* slots,
                  float eps2, int mixed, void* keep_stats, void* pass_stats,
                  void* keys,
                  unsigned char* grp, unsigned char* flags, int* out,
                  void* stream) {
  if (nqt <= 0 || qb <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int nb = C / block;
  const int G = (qb + 31) / 32;
  u64* k = reinterpret_cast<u64*>(keys);
  const long long nrows = (long long)nqt * qb;
  const int slabs = (G + PQ_GROUPS - 1) / PQ_GROUPS;

  query_rows_kernel<<<dim3(nqt, slabs), PQ_THREADS, 0, s>>>(
      q, tile_leaf, d, qb, G, reinterpret_cast<const u64*>(pad_keys), grp,
      k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (mixed) {
    err = cudaMemsetAsync(flags, 0, (size_t)nqt * G * nb, s);
    if (err != cudaSuccess) return (int)err;
  }
  const int span = pq_span(d);
  const int dp = (d + 3) & ~3;
  const size_t smem = (size_t)span * dp * 4 + (size_t)span * 4;
  const dim3 pgrid(nqt, (C + span - 1) / span, slabs);
  int bper = PQ_KEEP_COLS / block;
  if (bper < 1) bper = 1;
  const dim3 kgrid(nqt, (nb + bper - 1) / bper, slabs);
  u64* ks = reinterpret_cast<u64*>(keep_stats);
  u64* ps = reinterpret_cast<u64*>(pass_stats);
  const float4* sl = reinterpret_cast<const float4*>(slots);
  int rc;
#define PQ_LAUNCH(DCV)                                                      \
  launch_dc<DCV>(mixed, pgrid, kgrid, smem, s, q, tile_leaf, coords,       \
                 labels, ncols, d, qb, C, G, span, block, nb, bper,         \
                 leaf_end, ctr, sl, eps2, grp, flags, ks, ps, k)
  if (d <= 4)
    rc = PQ_LAUNCH(4);
  else if (d <= 8)
    rc = PQ_LAUNCH(8);
  else if (d <= 16)
    rc = PQ_LAUNCH(16);
  else if (d <= 32)
    rc = PQ_LAUNCH(32);
  else if (d <= 64)
    rc = PQ_LAUNCH(64);
  else
    rc = PQ_LAUNCH(0);
#undef PQ_LAUNCH
  if (rc != 0) return rc;
  const int ft = 256;
  query_unpack_kernel<<<(unsigned)((nrows + ft - 1) / ft), ft, 0, s>>>(
      k, nrows, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
