// Sketch-prefiltered eps-neighbourhood pair kernels for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU's Pallas kernels _count_pairs_sketch_kernel (B3) and
// _minlab_pairs_sketch_kernel (B4) in pypardis_tpu/ops/pallas_kernels.py.
// They compute what B1/B2 (pair_kernels.cu) compute - per point, the count
// of valid columns within eps (MODE 0) or the minimum source label within
// eps (MODE 1) over the live column tiles of its row tile - but decide most
// pairs from the (skp, N) sketch slab of ops/cuda_kernels.sketch_stage:
// rows 0..k-1 the projection Q^T x, row k the residual norm r, zero rows
// up to skp.  Per pair, with t2 the slab distance:
//   t2 - band > eps2             -> certainly out;
//   t2 + (4 rx) ry <= eps2 - band -> certainly in;
//   anything else                -> in band: the exact d2 decides.
// The band certifies both gates against the exact d2, so the results equal
// B1/B2's on any data.  B3 also counts the in-band pairs whose column is
// valid (every row, as the JAX kernel counts them) and flags each pair-list
// entry that holds one.
//
// Design.  As in B1/B2, one block owns 256 rows of a row tile and walks its
// CSR list of live column tiles; each thread owns one output row; no atomics
// on the outputs.  Columns go in chunks of 32, one bit each in a 32-bit mask:
//   1. stage the chunk's slab columns and column values in shared memory
//      with cp.async, and start the copy of its full-d columns (the first
//      512 axes) behind them;
//   2. each thread computes t2 for its row against the 32 columns (32
//      accumulators in registers, its row's slab values read from global
//      memory eight axes at a time, the columns as float4 broadcasts from
//      shared memory) and classifies them;
//   3. the in-band bits are OR-reduced over the warp and the block; if any
//      row of the block needs the exact d2, the block waits for the full-d
//      columns (further slices of 512 axes are staged in turn, so any d
//      fits), and a warp rescores only the groups of 8 columns its own
//      rows need: B4 with the exact d2, B3 on the tensor cores with a
//      per-pair band and an exact fallback (below).  So the rescore
//      runs per pair group, not per 512 x 512 tile as on the TPU: sure-out
//      pairs of a mixed tile cost the gate only.
// Every distance is the axis-ordered sum of (x_a - y_a)^2 with __fsub_rn /
// __fmul_rn / __fadd_rn (no contraction into FMA): the exact d2 is B1's own
// arithmetic, t2 and up are the plain version's (ops/distances.
// _sketch_over_pairs) in its order, so kernel and plain version are bitwise
// equal, stats included.  Zero-padded axes add +0 and change nothing.
//
// Bound.  Per pair the gate spends 3 skp FP32 operations (3 (k + 1) of
// them the function's own, the rest on zero pad rows) and the in-band
// pairs 3d more under the exact rescore (B4), or 2 K tensor-core
// operations each under the certified rescore (B3), plus 3d + 1 FP32
// ones for the few it queues; the bytes (coordinates, slab and CSR once)
// are far below, so the kernels are bound by FP32 SIMT throughput (B3's
// gate, B4's gate and rescore).  The arithmetic is unfused
// (__fsub_rn/__fmul_rn/__fadd_rn), so each operation is one FP32
// instruction: the SIMT ceiling is half the card's FFMA-counted 67 TFLOP/s.
// The 32 independent accumulators give each thread the instruction-level
// parallelism to keep its FP32 pipe busy at the low occupancy the
// shared-memory staging allows (two blocks per SM); the full-d copy
// overlaps the gate.
//
// B4's label-bound skip (MODE 1 only; B3 counts every pair and skips
// nothing).  B4's output is a minimum, so most of its pairs cannot change
// it:
//   - row r keeps a running minimum m_r, starting at INT32_MAX (never at
//     its own label: under "default" the bf16 self-pair verdict can miss);
//   - L_C, the minimum column value over a chunk C's columns (INT32_MAX,
//     the non-source value, when C holds no source), bounds every label C
//     can give r from below, so if L_C >= m_r, skipping C leaves r's final
//     minimum unchanged whatever the verdicts inside C;
//   - so a block may skip C when L_C >= its bound, the max of m_r over its
//     active rows.  The skip never looks at a distance: it is exact in
//     every mode, and the output is bitwise the plain version's.
// Both levels are decided uniformly over the block before any cp.async of
// that work starts: a pair-list entry whose column tile's minimum label
// (the wrapper's (nt,) tile_min, one torch reduction) is >= the bound is
// passed over whole; a chunk is passed over when L_C, a __reduce_min_sync
// of the 32 labels each warp reads from global memory itself (lb_find,
// label_bound.cuh: no barrier is spent on a skipped chunk), is >= the
// bound.  The bound is a
// __reduce_max_sync per warp plus a max over the warps in shared memory,
// refreshed at the barrier that opens each evaluated chunk.
// Inside an evaluated chunk a warp whose own max of m_r is <= L_C skips
// the gate and the rescore arithmetic; it still takes the block's
// barriers and adds 0 to the block's band mask.  The CSR list ascends in
// column tile, so a cluster's low labels come early and the bound falls
// fast.  `evaluated` (optional) counts the (block, chunk) pairs evaluated.
//
// The chunks B4 evaluates are staged as B3's are, one at a time.  A
// double-buffered version that copied the next chunk the bound did not
// skip during the gate measured 11-12 % slower at 1M x 512 (unprofiled;
// its search for that chunk ran before the gate, and the falling bound
// often dropped the chunk it had copied).
//
// Precision modes and the rescore (an explicit argument of the C
// interface, SK_EXACT / SK_BF16 / SK_CERTIFIED; the template's FAST is
// its value):
//   - B4 under "high", "highest" and "mixed" (FAST = 0) rescores with the
//     exact per-8-column-group FP32 sum above (the TPU kernels rescore at
//     "high" under "mixed"; the band comes from sketch_gate_band there);
//   - "default" (FAST = 1, B3 and B4, with the row tiles' box centres)
//     decides the in-band pairs with the bf16 tile routine of
//     bf16_tile.cuh instead, as the TPU kernel's single bf16 dot does: a
//     warp that needs a rescore runs mma.sync over its 32 rows x the
//     8-column groups it needs, K = d padded to 16, the rows recentred on
//     the row tile's centre and read from global memory, the columns
//     converted from the same staged FP32 slices the exact rescore reads;
//     the squared norms are FP32 sums, and each row's verdict bits are
//     folded across the quad that holds them and handed to the lane that
//     owns the row;
//   - B3 under "high", "highest" and "mixed" (FAST = 2, the certified
//     rescore) runs the same kind of mma.sync pass, laid out for reuse:
//     the block converts the staged FP32 columns once per sub-slice of
//     SK_KB axes, recentred and rounded to bf16, into shared memory
//     (sk_stage_bf16, which also leaves their partial squared norms), and
//     each warp reads its A fragments as one 16-byte load per 16 rows and
//     k-step from xfrag, the rows recentred on their tile's centre and
//     rounded to bf16 once per launch by the wrapper
//     (ops/cuda_kernels.row_fragments).  Each in-band pair is
//     decided by its own band band_p (below): d2f + band_p < eps2 is in,
//     d2f - band_p > eps2 is out, and any other pair goes to the warp's
//     queue in shared memory (windows of SK_QCAP of the at most 32 x 32
//     pairs).  At the end of the chunk the warp's lanes take the queued
//     pairs one each and decide them with B1's exact axis-ordered _rn d2,
//     the row from a row-major copy of the points (in the (d, n) layout a
//     point's axes lie n floats apart: reading them one pair at a time,
//     the first form, measured slower than the exact rescore it
//     replaces), the column from the staged FP32 slice (from the
//     row-major copy when d needs more than one slice), each lane's loads
//     issued 32 axes ahead of the serial sum.  The exact verdicts add to a
//     per-row count in shared memory that the row's lane adds to its own
//     at the end.  rescored_pairs (optional) counts the queued pairs.
//     So B3's counts and stats stay bitwise its plain version's
//     (ops/distances.counts_over_pairs_sketch) on any data, as long as
//     band_p bounds |d2f - E|, E the exact d2 the plain version compares.
//
// The certified band.  For one in-band pair, x and y its FP32 row and
// column, c the row tile's centre; u = 2^-24 (FP32 round to nearest),
// ub = 2^-8 (bf16 round to nearest: 8 significant bits), K = d padded to
// 16.  X = fl(x - c), Y = fl(y - c) (the recentred operands, each axis
// within a relative u of x - c and y - c), X' = bf16(X), Y' = bf16(Y),
// ex = X' - X, ey = Y' - Y (exact in FP32: X' lies within a factor 2 of
// X); A = |X|^2, B = |Y|^2, S = A + B, so |X| |Y| <= S / 2; D = |x - y|^2
// in real arithmetic.  The kernel computes xx, yy (_rn sums of fl(X_a^2),
// fl(Y_a^2), in some order), dot (the tensor cores' sum of X'_a Y'_a) and
// d2f = fl(fl(xx + yy) - 2 dot); the plain version's verdict is E <= eps2,
// E the axis-ordered _rn sum of fl(fl(x_a - y_a)^2).  Each bound below is
// first order: it omits factors (1 + t) with |t| <= gamma_m = m u /
// (1 - m u), m <= d + 8 K + 16, which h below covers.  Then:
//   (1) norms: |xx - A| + |yy - B| <= d u S (d non-negative terms, one
//       rounding per product and per add, any order);
//   (2) bf16 operands: P' = sum X'_a Y'_a = X.Y + ex.Y' + X.ey, so
//       |P' - X.Y| <= |ex| |Y'| + |X| |ey| (Cauchy-Schwarz), exactly; the
//       kernel takes these norms as they are, which RN at ub bounds by
//       ub |X| |Y'| + ub |X| |Y| <= (2 ub + ub^2) |X| |Y| at worst (the
//       2 (2 ub + ub^2) |X| |Y| of d2f), and by about 0.4 of that on
//       typical data.  The products X'_a Y'_a are exact in FP32; doubled
//       in d2f: 2 (|ex| |Y'| + |X| |ey|);
//   (3) the FP32 accumulation of the K products, in an unspecified order,
//       with rounding or truncation: every product's alignment and every
//       partial sum's rounding errs by at most 2^-23 of a magnitude
//       <= 2 (sum |p| + e), e = |dot - P'| (assuming at least 24
//       significant bits of the largest addend are kept: the probe
//       pp_mma_dot_probe below measures it on the card), and there are at
//       most 2K such events, so e <= 2^-21 K (sum |p| + e), e <= 2^-21 K
//       sum |p| / (1 - 2^-21 K) <= 2^-21 K |X'| |Y'| (1 + t), 2^-21 K =
//       8 K u; doubled: 2^-20 K |X'| |Y'|;
//   (4) the final fadd and fsub of d2f: <= u (xx + yy) + u |fl(xx + yy)
//       - 2 dot| <= u S + u (2 + 2^-6) S <= 4 u S (|fl(xx + yy) - 2 dot|
//       is |X - Y|^2 <= 2 S plus (2), at most 2^-7 S, plus (1)-(3));
//   (5) the recentring: X - Y = (x - y) + e with |e| <= u (|x - c| + |y - c|),
//       so ||X - Y|^2 - D| <= (2 u + u^2)(|X| + |Y|)^2 <= 4 u S to first
//       order (with A + B - 2 X.Y = |X - Y|^2 exactly);
//   (6) the exact sum itself: 3 roundings per term and d - 1 adds of
//       non-negative terms, |E - D| <= gamma_{d+2} D, D <= 2 S, so
//       <= 2 (d + 2) u S to first order.
// Sum: |d2f - E| <= 2 (|ex| |Y'| + |X| |ey|) + 2^-20 K |X'| |Y'|
// + (3 d + 12) u S, each term times at most 1 + gamma_m.
// The kernel has FP32 values of these norms (sums as in (1), each term
// through at most d + 16 roundings on any of the kernel's summation
// trees, then __fsqrt_rn), each at least (1 - u)^(d/2 + 9) of the truth,
// and its band arithmetic rounds at most 7 times more, so band_p keeps at
// least (1 - u)^(d + 25) >= 1 - (d + 25) u of each term.  With
//   h = 1 / (1 - (2 d + 8 K + 64) u)  (>= (1 + gamma_m) / (1 - (d + 25) u))
// the kernel takes
//   band_p = fl(fl(fl(c_cross fl(fl(xe yh) + fl(xn ye)))
//                 + fl(c_acc fl(xh yh))) + fl(fl(c_norm fl(xx + yy))
//                 + 2^-100)),
// xn = |X|, xh = |X'|, xe = |ex| of the row and yh, ye of the column,
// c_cross = 1.25 2 h, c_acc = 1.25 2^-20 K h and c_norm = 1.25 (3 d + 12)
// 2^-24 h in double, rounded up to FP32 on the host (launch_mode; the
// plain emulation ops/distances.certified_band_coefs is the same
// expression): 1.25 times each term, so band_p > the bound at any d.
// Where (2 d + 8 K + 64) u >= 1 (d past 1.6 million) h is infinite, so is
// band_p (or NaN), and every in-band pair takes the exact path.  The
// 2^-100 covers underflow (subnormal products, a flush to zero of
// subnormal operands or products on the tensor cores: < 2^-110 in all).
// The tests: fl(d2f + band_p) < eps2 implies d2f + band_p < eps2
// (round to nearest is monotone and eps2 is a float), hence E < eps2, in;
// the strict < matters, as fl(...) <= eps2 would not imply it.
// fl(d2f - band_p) > eps2 implies E > eps2, out.  A NaN or infinite d2f
// or band_p fails both tests and goes to the exact path.  At 1M x 512
// (|x - c| ~ 1.1) band_p is about 0.01 against eps^2 = 4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_tile.cuh"
#include "label_bound.cuh"

#define SK_INT_INF 2147483647
#define SK_INT_MIN (-SK_INT_INF - 1)
#define SK_THREADS 256
#define SK_WARPS (SK_THREADS / 32)
#define SK_CH 32    // columns per chunk: one bit each in a 32-bit mask
static_assert(SK_CH == LB_CHUNK, "B4 walks the chunks lb_find searches");
#define SK_AX 8     // axes per register step
#define SK_AXMAX 512  // full-d axes staged per slice
// The rescore, the C interface's explicit choice (the template's FAST).
#define SK_EXACT 0      // B4, exact modes: FP32 per 8-column group
#define SK_BF16 1       // "default": the bf16 verdict (lossy)
#define SK_CERTIFIED 2  // B3, exact modes: bf16, band_p, exact fallback
#define SK_KB 256     // axes per bf16 column sub-slice (certified rescore)
#define SK_QCAP 256   // queued pairs per warp and round of windows

// acc[c] += (x - y_c)^2 for the 8 columns of y (two float4s), rounded
// separately.
__device__ __forceinline__ void sk_acc8(float* acc, float x, float4 ya,
                                        float4 yb) {
  float df;
  df = __fsub_rn(x, ya.x); acc[0] = __fadd_rn(acc[0], __fmul_rn(df, df));
  df = __fsub_rn(x, ya.y); acc[1] = __fadd_rn(acc[1], __fmul_rn(df, df));
  df = __fsub_rn(x, ya.z); acc[2] = __fadd_rn(acc[2], __fmul_rn(df, df));
  df = __fsub_rn(x, ya.w); acc[3] = __fadd_rn(acc[3], __fmul_rn(df, df));
  df = __fsub_rn(x, yb.x); acc[4] = __fadd_rn(acc[4], __fmul_rn(df, df));
  df = __fsub_rn(x, yb.y); acc[5] = __fadd_rn(acc[5], __fmul_rn(df, df));
  df = __fsub_rn(x, yb.z); acc[6] = __fadd_rn(acc[6], __fmul_rn(df, df));
  df = __fsub_rn(x, yb.w); acc[7] = __fadd_rn(acc[7], __fmul_rn(df, df));
}

// The certified rescore's per-pair band (see the header) from the row's
// |X|^2, |X|, |X'|, |ex| and the column's |Y|^2, |Y'|, |ey|.
__device__ __forceinline__ float sk_pair_band(float c_cross, float c_acc,
                                              float c_norm,
                                              float xx, float xn, float xh,
                                              float xe, float yy, float yh,
                                              float ye) {
  const float cross = __fadd_rn(__fmul_rn(xe, yh), __fmul_rn(xn, ye));
  const float b = __fadd_rn(__fmul_rn(c_cross, cross),
                            __fmul_rn(c_acc, __fmul_rn(xh, yh)));
  return __fadd_rn(
      b, __fadd_rn(__fmul_rn(c_norm, __fadd_rn(xx, yy)), 0x1p-100f));
}

// v rounded to bf16 (nearest even) and back.
__device__ __forceinline__ float sk_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc += (u - v)^2 over the four axes of u, v, in order, rounded
// separately.
__device__ __forceinline__ float sk_acc4(float acc, float4 u, float4 v) {
  float df;
  df = __fsub_rn(u.x, v.x); acc = __fadd_rn(acc, __fmul_rn(df, df));
  df = __fsub_rn(u.y, v.y); acc = __fadd_rn(acc, __fmul_rn(df, df));
  df = __fsub_rn(u.z, v.z); acc = __fadd_rn(acc, __fmul_rn(df, df));
  df = __fsub_rn(u.w, v.w); acc = __fadd_rn(acc, __fmul_rn(df, df));
  return acc;
}

// B1's exact d2 of two rows of the row-major copy: the axis-ordered sum
// of separately rounded squares.  With d a multiple of 4 the rows go as
// float4s, 32 axes' loads issued before their arithmetic (the sum is a
// serial chain, so only loads issued ahead keep the memory busy).
__device__ __forceinline__ float sk_exact_d2(const float* __restrict__ x,
                                             const float* __restrict__ y,
                                             int d) {
  float d2 = 0.f;
  if ((d & 3) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    int q = 0;
    for (; q + 8 <= d / 4; q += 8) {
      float4 u[8], v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        u[i] = __ldg(x4 + q + i);
        v[i] = __ldg(y4 + q + i);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) d2 = sk_acc4(d2, u[i], v[i]);
    }
    for (; q < d / 4; ++q) d2 = sk_acc4(d2, __ldg(x4 + q), __ldg(y4 + q));
  } else {
    for (int a = 0; a < d; ++a) {
      const float df = __fsub_rn(__ldg(x + a), __ldg(y + a));
      d2 = __fadd_rn(d2, __fmul_rn(df, df));
    }
  }
  return d2;
}

// B1's exact d2 of a row of the row-major copy against column cl of the
// staged FP32 columns ys (all d axes): as sk_exact_d2, the row's loads
// issued 32 axes ahead of their arithmetic.
__device__ __forceinline__ float sk_exact_d2_ys(const float* __restrict__ x,
                                                const float* ys, int cl,
                                                int d) {
  float d2 = 0.f;
  int a = 0;
  if ((d & 3) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (; a + 32 <= d; a += 32) {
      float4 u[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) u[i] = __ldg(x4 + a / 4 + i);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* y = ys + (a + 4 * i) * SK_CH + cl;
        d2 = sk_acc4(d2, u[i],
                     make_float4(y[0], y[SK_CH], y[2 * SK_CH], y[3 * SK_CH]));
      }
    }
  }
  for (; a < d; ++a) {
    const float df = __fsub_rn(__ldg(x + a), ys[a * SK_CH + cl]);
    d2 = __fadd_rn(d2, __fmul_rn(df, df));
  }
  return d2;
}

// The certified rescore's column staging: axes [a0, a0 + as) of the
// chunk's staged FP32 columns (ys rows, global axes from g0) recentred on
// the row tile's centre, rounded to bf16 into yb (column-major, stride
// SK_KB + 8 halves, conflict-free for the B fragments' 32-bit loads),
// zeros past d and past the chunk's width.  Thread (axis phase i, column
// t) also leaves in part[q * SK_THREADS + i * SK_CH + t] the FP32 sums
// over its axes (i, i + SK_WARPS, ...) of Y^2 (q = 0), Y'^2 (1) and
// (Y' - Y)^2 (2), which the warps add in phase order.
__device__ __forceinline__ void sk_stage_bf16(
    __nv_bfloat16* yb, float* part, const float* ys,
    const float* __restrict__ ctr, int d, int g0, int a0, int as, int w) {
  const int t = threadIdx.x & 31;
  const int i = threadIdx.x >> 5;
  float sy = 0.f, sh = 0.f, se = 0.f;
  for (int a = i; a < as; a += SK_WARPS) {
    const int ga = g0 + a;
    const float v = t < w && ga < d
                        ? __fsub_rn(ys[(a0 + a) * SK_CH + t], __ldg(ctr + ga))
                        : 0.f;
    const __nv_bfloat16 vb = __float2bfloat16_rn(v);
    const float vh = __bfloat162float(vb);
    const float ve = __fsub_rn(vh, v);
    sy = __fadd_rn(sy, __fmul_rn(v, v));
    sh = __fadd_rn(sh, __fmul_rn(vh, vh));
    se = __fadd_rn(se, __fmul_rn(ve, ve));
    yb[t * (SK_KB + 8) + a] = vb;
  }
  part[i * SK_CH + t] = sy;
  part[SK_THREADS + i * SK_CH + t] = sh;
  part[2 * SK_THREADS + i * SK_CH + t] = se;
}

// Verdict bits in the mma accumulator layout (rm[mt][h]: row
// mt*16 + h*8 + g of the warp, one bit per column, folded across the
// quad) handed to the lane that owns the row.
__device__ __forceinline__ unsigned sk_to_owner(const unsigned (&rm)[2][2],
                                                int lane) {
  const int src = (lane & 7) * 4;
  const unsigned v00 = __shfl_sync(0xffffffffu, rm[0][0], src);
  const unsigned v01 = __shfl_sync(0xffffffffu, rm[0][1], src);
  const unsigned v10 = __shfl_sync(0xffffffffu, rm[1][0], src);
  const unsigned v11 = __shfl_sync(0xffffffffu, rm[1][1], src);
  const int sel = lane >> 3;
  return sel == 0 ? v00 : sel == 1 ? v01 : sel == 2 ? v10 : v11;
}

// Groups of asynchronous copies (each copy an lb_cp4, label_bound.cuh).
__device__ __forceinline__ void sk_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void sk_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies axes [s0, s0 + as) of the chunk's full-d columns into ys.
__device__ __forceinline__ void sk_stage_full(
    float* ys, const float* __restrict__ pts, long long n, int d, int s0,
    int as, long long col0, int w) {
  for (int e = threadIdx.x; e < as * SK_CH; e += blockDim.x) {
    const int a = s0 + e / SK_CH;
    const int t = e % SK_CH;
    const bool in = t < w && a < d;
    lb_cp4(ys + e, in ? pts + a * n + col0 + t : pts, in ? 4 : 0);
  }
}

template <int MODE, int FAST>
__global__ void __launch_bounds__(SK_THREADS) sketch_pair_kernel(
    const float* __restrict__ pts, const float* __restrict__ slab,
    const int* __restrict__ colval, const int* __restrict__ row_ptr,
    const int* __restrict__ cols, const float* __restrict__ centers,
    const float* __restrict__ prow, const uint4* __restrict__ xfrag,
    float eps2, float band, long long n, int d, int dp, int ax, int skp,
    int k, int tile, float c_cross, float c_acc, float c_norm,
    int* __restrict__ out,
    unsigned long long* __restrict__ band_pairs, int* __restrict__ flags,
    unsigned long long* __restrict__ rescored,
    const int* __restrict__ tile_min,
    unsigned long long* __restrict__ evaluated) {
  extern __shared__ float4 smem4[];
  // The full-d columns, FP32 ax x SK_CH, and (FAST == 2) a sub-slice of
  // them recentred in bf16, SK_CH x (SK_KB + 8) (sk_stage_bf16).
  float* ys = reinterpret_cast<float*>(smem4);
  __nv_bfloat16* yb = reinterpret_cast<__nv_bfloat16*>(ys + (size_t)ax * SK_CH);
  float* ss = ys + (size_t)ax * SK_CH +
              (FAST == 2 ? SK_CH / 2 * (SK_KB + 8) : 0);  // skp x SK_CH
  int* sv = reinterpret_cast<int*>(ss + (size_t)skp * SK_CH);  // SK_CH
  // The certified rescore (FAST == 2 only): the columns' partial squared
  // norms, each row's count of exact verdicts within eps and each warp's
  // queue of (row, column) pairs.
  float* part = reinterpret_cast<float*>(sv + SK_CH);     // 3 x SK_THREADS
  unsigned* cqin = reinterpret_cast<unsigned*>(part + 3 * SK_THREADS);
  unsigned short* cq =
      reinterpret_cast<unsigned short*>(cqin + SK_THREADS);  // 8 x SK_QCAP
  __shared__ unsigned block_band;
  __shared__ unsigned long long warp_sum[SK_WARPS];
  __shared__ int warp_max[SK_WARPS];

  const int r = blockIdx.x;
  const int local = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = local < tile;
  const long long row = (long long)r * tile + (active ? local : 0);
  const int lane = threadIdx.x & 31;
  const float lo = __fsub_rn(eps2, band);
  const float rx4 = __fmul_rn(4.f, slab[(long long)k * n + row]);
  const int inval = MODE == 0 ? 0 : SK_INT_INF;

  int res = MODE == 0 ? 0 : SK_INT_INF;
  unsigned n_band = 0;
  unsigned long long n_resc = 0;
  // The certified rescore's exact fallback: this warp's per-row counts of
  // pairs within eps.
  int* wcnt = reinterpret_cast<int*>(cqin) + (threadIdx.x & ~31);
  if (FAST == 2) cqin[threadIdx.x] = 0u;
  // The bf16 rescores: the row tile's centre and this row's |x - c|^2.
  const float* ctr = FAST ? centers + (long long)r * d : nullptr;
  float xxr = 0.f;
  float xn = 0.f, xh = 0.f, xe = 0.f;  // FAST == 2: |X|, |X'|, |X' - X|
  if (FAST == 2) {
    float h2 = 0.f, e2 = 0.f;
    for (int a = 0; a < d; ++a) {
      const float v = __fsub_rn(__ldg(prow + row * d + a), __ldg(ctr + a));
      const float vh = sk_bf16(v);
      const float ve = __fsub_rn(vh, v);
      xxr = __fadd_rn(xxr, __fmul_rn(v, v));
      h2 = __fadd_rn(h2, __fmul_rn(vh, vh));
      e2 = __fadd_rn(e2, __fmul_rn(ve, ve));
    }
    xn = __fsqrt_rn(xxr);
    xh = __fsqrt_rn(h2);
    xe = __fsqrt_rn(e2);
  } else if (FAST) {
    for (int a = 0; a < d; ++a) {
      const float df = __fsub_rn(__ldg(pts + a * n + row), __ldg(ctr + a));
      xxr = __fadd_rn(xxr, __fmul_rn(df, df));
    }
  }
  const long long wrow0 = (long long)r * tile + blockIdx.y * blockDim.x +
                          (threadIdx.x & ~31);  // the warp's first row
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int p1 = row_ptr[r + 1];
  // The walk over the pair list's chunks, (entry p, column j0).  B4 keeps
  // its block's bound and passes over what it cannot use (see the header).
  int p = row_ptr[r], j0 = 0;
  int L = SK_INT_INF;   // B4: the chunk's least label
  int wmax = 0;         // B4: the warp's largest running minimum
  unsigned long long n_eval = 0;
  while (true) {
    if (MODE == 1) {
      wmax = __reduce_max_sync(0xffffffffu, active ? res : SK_INT_MIN);
      if (lane == 0) warp_max[threadIdx.x / 32] = wmax;
    }
    sk_wait<0>();     // no copy of the previous chunk is in flight
    __syncthreads();  // and no thread reads its shared memory any more
    if (MODE == 1) {
      int bnd = warp_max[0];
#pragma unroll
      for (int i = 1; i < SK_WARPS; ++i) bnd = max(bnd, warp_max[i]);
      if (!lb_find(colval, cols, tile_min, tile, p1, bnd, p, j0, L)) break;
    } else if (p >= p1) {
      break;
    }
    {
      const int w = min(SK_CH, tile - j0);
      const long long col0 = (long long)cols[p] * tile + j0;
      if (threadIdx.x == 0) block_band = 0u;
      // Group 1: the column values and the slab columns.
      if (threadIdx.x < SK_CH) {
        if (threadIdx.x < w)
          lb_cp4(sv + threadIdx.x, colval + col0 + threadIdx.x, 4);
        else
          sv[threadIdx.x] = inval;
      }
      for (int e = threadIdx.x; e < skp * SK_CH; e += blockDim.x) {
        const int a = e / SK_CH;
        const int t = e % SK_CH;
        lb_cp4(ss + e, t < w ? slab + a * n + col0 + t : slab, t < w ? 4 : 0);
      }
      sk_commit();
      // Group 2: the first full-d slice, in flight during the gate (most
      // chunks of a cluster need it; a chunk that does not waits for it
      // at the next chunk's top).
      sk_stage_full(ys, pts, n, d, 0, ax, col0, w);
      sk_commit();
      sk_wait<1>();
      __syncthreads();

      // The gate: t2 over the slab rows for 32 columns (skipped by a B4
      // warp none of whose rows the chunk can lower; one guard around the
      // whole gate, which measured faster than the guard in its loop).
      const bool live = MODE == 0 || wmax > L;
      float acc[SK_CH];
#pragma unroll
      for (int c = 0; c < SK_CH; ++c) acc[c] = 0.f;
      unsigned in_m = 0u, band_m = 0u;
      if (live) {
        for (int a0 = 0; a0 < skp; a0 += SK_AX) {
          float xr[SK_AX];
#pragma unroll
          for (int i = 0; i < SK_AX; ++i)
            xr[i] = __ldg(slab + (a0 + i) * n + row);
#pragma unroll
          for (int i = 0; i < SK_AX; ++i) {
            const float4* y4 =
                reinterpret_cast<const float4*>(ss + (a0 + i) * SK_CH);
#pragma unroll
            for (int g = 0; g < SK_CH / 8; ++g)
              sk_acc8(acc + 8 * g, xr[i], y4[2 * g], y4[2 * g + 1]);
          }
        }
#pragma unroll
        for (int c = 0; c < SK_CH; ++c) {
          const int v = sv[c];
          const bool valid = MODE == 0 ? v != 0 : v != SK_INT_INF;
          const float up =
              __fadd_rn(acc[c], __fmul_rn(rx4, ss[k * SK_CH + c]));
          if (active && valid) {
            if (up <= lo)
              in_m |= 1u << c;
            else if (!(__fsub_rn(acc[c], band) > eps2))
              band_m |= 1u << c;
          }
        }
      }
      n_band += __popc(band_m);
      const unsigned warp_m = __reduce_or_sync(0xffffffffu, band_m);
      if (lane == 0 && warp_m) atomicOr(&block_band, warp_m);
      __syncthreads();
      const unsigned bm = block_band;  // uniform over the block

      // The rescore: exact d2 (or, FAST, the bf16 d2f) for the 8-column
      // groups a warp needs.
      if (bm) {
        if (MODE == 0 && threadIdx.x == 0 && flags) flags[p] = 1;
#pragma unroll
        for (int c = 0; c < SK_CH; ++c) acc[c] = 0.f;
        float yyc = 0.f;  // FAST: |y - c|^2 of column `lane`
        float yh2 = 0.f, ye2 = 0.f;  // FAST == 2: |Y'|^2, |Y' - Y|^2
        for (int s0 = 0; s0 < dp; s0 += ax) {
          const int as = min(ax, dp - s0);
          if (s0 > 0) {
            __syncthreads();  // the previous slice is consumed
            sk_stage_full(ys, pts, n, d, s0, as, col0, w);
            sk_commit();
          }
          sk_wait<0>();
          __syncthreads();
          if (FAST == 2) {
            // The block converts each sub-slice of the staged columns to
            // bf16 once; each warp that needs them runs the mma over its
            // 32 rows, reading its two 16-row groups of the row tile's
            // fragments.
            for (int kb = 0; kb < as; kb += SK_KB) {
              const int ks = min(SK_KB, as - kb);
              if (kb > 0) __syncthreads();  // the sub-slice is consumed
              sk_stage_bf16(yb, part, ys, ctr, d, s0 + kb, kb, ks, w);
              __syncthreads();
              if (!warp_m) continue;
              float sy = part[lane], sh = part[SK_THREADS + lane],
                    se = part[2 * SK_THREADS + lane];
#pragma unroll
              for (int i = 1; i < SK_WARPS; ++i) {
                sy = __fadd_rn(sy, part[i * SK_CH + lane]);
                sh = __fadd_rn(sh, part[SK_THREADS + i * SK_CH + lane]);
                se = __fadd_rn(se, part[2 * SK_THREADS + i * SK_CH + lane]);
              }
              yyc = __fadd_rn(yyc, sy);
              yh2 = __fadd_rn(yh2, sh);
              ye2 = __fadd_rn(ye2, se);
              const uint4* xw =
                  xfrag + (((long long)r * ((tile + 31) / 32 * 2) +
                            (blockIdx.y * blockDim.x + (threadIdx.x & ~31)) /
                                16) *
                               (dp / 16) +
                           (s0 + kb) / 16) *
                              32 +
                          lane;
              for (int k0 = 0; k0 < ks; k0 += 16) {
                unsigned af[2][4];
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                  const uint4 v = __ldg(xw + ((long long)mt * (dp / 16) +
                                              k0 / 16) *
                                                 32);
                  af[mt][0] = v.x;
                  af[mt][1] = v.y;
                  af[mt][2] = v.z;
                  af[mt][3] = v.w;
                }
#pragma unroll
                for (int j = 0; j < SK_CH / 8; ++j) {
                  if (!((warp_m >> (8 * j)) & 0xffu)) continue;
                  const __nv_bfloat16* bp =
                      yb + (j * 8 + g) * (SK_KB + 8) + k0 + t4 * 2;
                  unsigned b[2] = {*reinterpret_cast<const unsigned*>(bp),
                                   *reinterpret_cast<const unsigned*>(bp + 8)};
                  bt_mma(acc + (0 * 4 + j) * 4, af[0], b);
                  bt_mma(acc + (1 * 4 + j) * 4, af[1], b);
                }
              }
            }
          } else if (FAST && warp_m) {
            for (int a = 0; a < as && s0 + a < d; ++a) {
              const float df = __fsub_rn(ys[a * SK_CH + lane],
                                         __ldg(ctr + s0 + a));
              yyc = __fadd_rn(yyc, __fmul_rn(df, df));
            }
            for (int k0 = 0; k0 < as; k0 += 16) {
              unsigned af[2][4];
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                const long long ra = wrow0 + mt * 16 + g;
                float v[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                  const int a = s0 + k0 + t4 * 2 + (i & 1) + (i >> 2) * 8;
                  const long long rr = ra + ((i >> 1) & 1) * 8;
                  v[i] = (a < d && rr - (long long)r * tile < tile)
                             ? __fsub_rn(__ldg(pts + a * n + rr),
                                         __ldg(ctr + a))
                             : 0.f;
                }
                af[mt][0] = bt_pack(v[0], v[1]);
                af[mt][1] = bt_pack(v[2], v[3]);
                af[mt][2] = bt_pack(v[4], v[5]);
                af[mt][3] = bt_pack(v[6], v[7]);
              }
#pragma unroll
              for (int j = 0; j < SK_CH / 8; ++j) {
                if (!((warp_m >> (8 * j)) & 0xffu)) continue;
                const int col = j * 8 + g;
                float v[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int al = k0 + t4 * 2 + (i & 1) + (i >> 1) * 8;
                  v[i] = s0 + al < d ? __fsub_rn(ys[al * SK_CH + col],
                                                 __ldg(ctr + s0 + al))
                                     : 0.f;
                }
                unsigned b[2] = {bt_pack(v[0], v[1]), bt_pack(v[2], v[3])};
                bt_mma(acc + (0 * 4 + j) * 4, af[0], b);
                bt_mma(acc + (1 * 4 + j) * 4, af[1], b);
              }
            }
          } else if (!FAST && warp_m) {
            for (int a0 = 0; a0 < as; a0 += SK_AX) {
              float xr[SK_AX];
#pragma unroll
              for (int i = 0; i < SK_AX; ++i)
                xr[i] = s0 + a0 + i < d ? __ldg(pts + (s0 + a0 + i) * n + row)
                                        : 0.f;
#pragma unroll
              for (int i = 0; i < SK_AX; ++i) {
                const float4* y4 =
                    reinterpret_cast<const float4*>(ys + (a0 + i) * SK_CH);
#pragma unroll
                for (int g = 0; g < SK_CH / 8; ++g)
                  if ((warp_m >> (8 * g)) & 0xffu)
                    sk_acc8(acc + 8 * g, xr[i], y4[2 * g], y4[2 * g + 1]);
              }
            }
          }
        }
        if (FAST == 1) {
          // acc[(mt * 4 + j) * 4 + e] holds row mt*16 + g (+8 for e >= 2)
          // of the warp against column j*8 + 2*t4 (+1 for odd e).
          unsigned rm[2][2] = {{0u, 0u}, {0u, 0u}};
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float xr = __shfl_sync(0xffffffffu, xxr, mt * 16 + h * 8 + g);
#pragma unroll
              for (int j = 0; j < SK_CH / 8; ++j) {
#pragma unroll
                for (int o = 0; o < 2; ++o) {
                  const int c = j * 8 + t4 * 2 + o;
                  const float yc = __shfl_sync(0xffffffffu, yyc, c);
                  const float d2f =
                      bt_d2f(xr, yc, acc[(mt * 4 + j) * 4 + h * 2 + o]);
                  if (d2f <= eps2) rm[mt][h] |= 1u << c;
                }
              }
              rm[mt][h] |= __shfl_xor_sync(0xffffffffu, rm[mt][h], 1);
              rm[mt][h] |= __shfl_xor_sync(0xffffffffu, rm[mt][h], 2);
            }
          }
          in_m |= band_m & sk_to_owner(rm, lane);
        } else if (FAST == 2) {
          // The certified verdicts: rin certainly in, ramb neither.  This
          // lane's 8 columns' norms, then each row's.
          unsigned rin[2][2] = {{0u, 0u}, {0u, 0u}};
          unsigned ramb[2][2] = {{0u, 0u}, {0u, 0u}};
          const float yh = __fsqrt_rn(yh2), ye = __fsqrt_rn(ye2);
          float cy[8], chh[8], ce[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int c = (q >> 1) * 8 + t4 * 2 + (q & 1);
            cy[q] = __shfl_sync(0xffffffffu, yyc, c);
            chh[q] = __shfl_sync(0xffffffffu, yh, c);
            ce[q] = __shfl_sync(0xffffffffu, ye, c);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int src = mt * 16 + h * 8 + g;
              const float xr = __shfl_sync(0xffffffffu, xxr, src);
              const float rn = __shfl_sync(0xffffffffu, xn, src);
              const float rh = __shfl_sync(0xffffffffu, xh, src);
              const float re = __shfl_sync(0xffffffffu, xe, src);
#pragma unroll
              for (int j = 0; j < SK_CH / 8; ++j) {
#pragma unroll
                for (int o = 0; o < 2; ++o) {
                  const int c = j * 8 + t4 * 2 + o;
                  const int q = j * 2 + o;
                  const float d2f =
                      bt_d2f(xr, cy[q], acc[(mt * 4 + j) * 4 + h * 2 + o]);
                  const float bp =
                      sk_pair_band(c_cross, c_acc, c_norm, xr, rn, rh, re,
                                   cy[q], chh[q], ce[q]);
                  if (__fadd_rn(d2f, bp) < eps2)
                    rin[mt][h] |= 1u << c;
                  else if (!(__fsub_rn(d2f, bp) > eps2))
                    ramb[mt][h] |= 1u << c;
                }
              }
              rin[mt][h] |= __shfl_xor_sync(0xffffffffu, rin[mt][h], 1);
              rin[mt][h] |= __shfl_xor_sync(0xffffffffu, rin[mt][h], 2);
              ramb[mt][h] |= __shfl_xor_sync(0xffffffffu, ramb[mt][h], 1);
              ramb[mt][h] |= __shfl_xor_sync(0xffffffffu, ramb[mt][h], 2);
            }
          }
          in_m |= band_m & sk_to_owner(rin, lane);
          // The queue: this row's undecided pairs at its exclusive
          // prefix over the warp's lanes.
          const unsigned qm = band_m & sk_to_owner(ramb, lane);
          const int nq = __popc(qm);
          int incl = nq;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int t = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += t;
          }
          const int tot = __shfl_sync(0xffffffffu, incl, 31);
          n_resc += nq;
          // B1's exact d2 for the queued pairs, one per lane, in windows of
          // SK_QCAP: the row from the row-major copy, the column from the
          // staged slice when d fits one.
          unsigned short* wq = cq + (threadIdx.x >> 5) * SK_QCAP;
          const bool staged = dp <= ax;
          for (int w0 = 0; w0 < tot; w0 += SK_QCAP) {  // uniform
            int o = incl - nq;
            for (unsigned m = qm; m; m &= m - 1u, ++o)
              if (o >= w0 && o < w0 + SK_QCAP)
                wq[o - w0] = (unsigned short)((lane << 5) | (__ffs(m) - 1));
            __syncwarp();
            for (int i = lane; i < min(tot - w0, SK_QCAP); i += 32) {
              const int e = wq[i];
              const int rl = e >> 5;
              const int cl = e & 31;
              const float* x = prow + (wrow0 + rl) * d;
              const float d2 =
                  staged ? sk_exact_d2_ys(x, ys, cl, d)
                         : sk_exact_d2(x, prow + (col0 + cl) * d, d);
              if (d2 <= eps2) atomicAdd(wcnt + rl, 1);
            }
            __syncwarp();
          }
        } else {
#pragma unroll
          for (int c = 0; c < SK_CH; ++c)
            if (((band_m >> c) & 1u) && acc[c] <= eps2) in_m |= 1u << c;
        }
      }

      if (MODE == 0) {
        res += __popc(in_m);
      } else {
#pragma unroll
        for (int c = 0; c < SK_CH; ++c)
          if ((in_m >> c) & 1u) res = min(res, sv[c]);
        ++n_eval;
      }
    }
    j0 += SK_CH;
    if (j0 >= tile) {
      j0 = 0;
      ++p;
    }
  }
  sk_wait<0>();  // a chunk without a rescore leaves its full-d copy in flight
  if (FAST == 2) res += wcnt[lane];  // the exact verdicts within eps
  if (active) out[row] = res;
  if (FAST == 2 && rescored) {
    unsigned long long v = n_resc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0 && v) atomicAdd(rescored, v);
  }
  if (MODE == 1 && evaluated && threadIdx.x == 0 && n_eval)
    atomicAdd(evaluated, n_eval);
  if (MODE == 0 && band_pairs) {
    unsigned long long v = n_band;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) warp_sum[threadIdx.x / 32] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long tot = 0;
      for (int i = 0; i < (int)(blockDim.x / 32); ++i) tot += warp_sum[i];
      if (tot) atomicAdd(band_pairs, tot);
    }
  }
}

// The probe of the certified band's term (3): block b sums a[b] (16, K)
// by b[b] (8, K) transposed, bf16 row-major with K a multiple of 16, as
// the certified rescore sums its cross term (one FP32 accumulator chained
// through mma.sync m16n8k16 over the k-steps in order), into out[b]
// (16, 8) float32.
__global__ void sk_mma_probe_kernel(const __nv_bfloat16* __restrict__ a,
                                    const __nv_bfloat16* __restrict__ b,
                                    int K, float* __restrict__ out) {
  const int lane = threadIdx.x;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const __nv_bfloat16* ab = a + (long long)blockIdx.x * 16 * K;
  const __nv_bfloat16* bb = b + (long long)blockIdx.x * 8 * K;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += 16) {
    const int c = k0 + 2 * t4;
    unsigned af[4], bf[2];
    af[0] = *reinterpret_cast<const unsigned*>(ab + g * K + c);
    af[1] = *reinterpret_cast<const unsigned*>(ab + (g + 8) * K + c);
    af[2] = *reinterpret_cast<const unsigned*>(ab + g * K + c + 8);
    af[3] = *reinterpret_cast<const unsigned*>(ab + (g + 8) * K + c + 8);
    bf[0] = *reinterpret_cast<const unsigned*>(bb + g * K + c);
    bf[1] = *reinterpret_cast<const unsigned*>(bb + g * K + c + 8);
    bt_mma(acc, af, bf);
  }
  float* o = out + (long long)blockIdx.x * 128;
  o[g * 8 + 2 * t4] = acc[0];
  o[g * 8 + 2 * t4 + 1] = acc[1];
  o[(g + 8) * 8 + 2 * t4] = acc[2];
  o[(g + 8) * 8 + 2 * t4 + 1] = acc[3];
}

// v rounded up to FP32.
static float sk_round_up(double v) {
  float f = (float)v;
  if ((double)f < v) f = nextafterf(f, INFINITY);
  return f;
}

template <int MODE, int FAST>
static int launch_mode(const float* pts, const float* slab, const int* colval,
                       const int* row_ptr, const int* cols,
                       const float* centers, const float* prow,
                       const uint4* xfrag, float eps2, float band,
                       long long n, int d, int skp, int k, int tile, int nt,
                       int* out, unsigned long long* band_pairs, int* flags,
                       unsigned long long* rescored, const int* tile_min,
                       unsigned long long* evaluated, void* stream) {
  // The bf16 rescores stage whole k-steps of 16 axes.
  const int al = FAST ? 16 : SK_AX;
  const int dp = (d + al - 1) / al * al;
  const int ax = dp < SK_AXMAX ? dp : SK_AXMAX;
  // The certified band's coefficients (see the header).
  const double hd = 1.0 - (2.0 * d + 8.0 * dp + 64.0) * ldexp(1.0, -24);
  const double h = hd > 0.0 ? 1.0 / hd : INFINITY;
  const float c_cross = FAST == 2 ? sk_round_up(2.5 * h) : 0.f;
  const float c_acc =
      FAST == 2 ? sk_round_up(1.25 * ldexp(1.0, -20) * dp * h) : 0.f;
  const float c_norm =
      FAST == 2 ? sk_round_up(1.25 * (3.0 * d + 12.0) * ldexp(1.0, -24) * h)
                : 0.f;
  // The full-d columns (FP32, or bf16 with a padded stride), the slab
  // columns and values, and (FAST == 2) the partial norms, the exact
  // verdict counts, the queues and the carried pairs.
  const size_t smem =
      ((size_t)ax * SK_CH + (size_t)skp * SK_CH + SK_CH) * 4 +
      (FAST == 2 ? (size_t)SK_CH * (SK_KB + 8) * 2 + (size_t)SK_THREADS * 16 +
                       (size_t)SK_WARPS * SK_QCAP * 2
                 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      sketch_pair_kernel<MODE, FAST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nt, (tile + SK_THREADS - 1) / SK_THREADS);
  sketch_pair_kernel<MODE, FAST><<<grid, SK_THREADS, smem,
                                   reinterpret_cast<cudaStream_t>(stream)>>>(
      pts, slab, colval, row_ptr, cols, centers, prow, xfrag, eps2, band, n,
      d, dp, ax,
      skp, k, tile, c_cross, c_acc, c_norm, out, band_pairs, flags, rescored,
      tile_min,
      evaluated);
  return (int)cudaGetLastError();
}

// B3 takes the bf16 or the certified rescore (both need the centres, the
// certified one the rows' row-major copy and bf16 fragments too), B4 the
// exact or the bf16 one (the centres only for the latter).
template <int MODE>
static int launch(const float* pts, const float* slab, const int* colval,
                  const int* row_ptr, const int* cols, const float* centers,
                  const float* prow, const void* xfrag, float eps2,
                  float band, long long n, int d, int skp, int k, int tile,
                  int nt, int rescore, int* out,
                  unsigned long long* band_pairs, int* flags,
                  unsigned long long* rescored, const int* tile_min,
                  unsigned long long* evaluated, void* stream) {
  if (nt <= 0 || tile <= 0) return 0;
  if (skp % SK_AX != 0 || k < 0 || k >= skp)
    return (int)cudaErrorInvalidValue;
  if (MODE == 1 && !tile_min) return (int)cudaErrorInvalidValue;
  if (rescore != SK_EXACT && !centers) return (int)cudaErrorInvalidValue;
  if (MODE == 0 && rescore == SK_CERTIFIED) {
    if (!prow || !xfrag) return (int)cudaErrorInvalidValue;
    return launch_mode<0, SK_CERTIFIED>(
        pts, slab, colval, row_ptr, cols, centers, prow,
        reinterpret_cast<const uint4*>(xfrag), eps2, band, n, d, skp, k,
        tile, nt, out, band_pairs, flags, rescored, nullptr, nullptr, stream);
  }
  if (MODE == 0 && rescore == SK_BF16)
    return launch_mode<0, SK_BF16>(
        pts, slab, colval, row_ptr, cols, centers, nullptr, nullptr, eps2,
        band, n, d, skp, k, tile, nt, out, band_pairs, flags, nullptr,
        nullptr, nullptr, stream);
  if (MODE == 1 && rescore == SK_BF16)
    return launch_mode<1, SK_BF16>(
        pts, slab, colval, row_ptr, cols, centers, nullptr, nullptr, eps2,
        band, n, d, skp, k, tile, nt, out, nullptr, nullptr, nullptr,
        tile_min, evaluated, stream);
  if (MODE == 1 && rescore == SK_EXACT)
    return launch_mode<1, SK_EXACT>(
        pts, slab, colval, row_ptr, cols, nullptr, nullptr, nullptr, eps2,
        band, n, d, skp, k, tile, nt, out, nullptr, nullptr, nullptr,
        tile_min, evaluated, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// B3: per-point neighbour counts through the sketch gate.  pts (d, n) and
// slab (skp, n) float32; mask (n,) int32; row_ptr (nt + 1,) int32; cols
// int32; centers (nt, d) float32, the row tiles' recentring points (box
// centres over the mask); rows (n, d) float32, pts transposed (row-major:
// the certified rescore's exact fallback reads a point's axes from it)
// and xfrag the rows recentred on their tile's centre and rounded to bf16
// in mma fragment order (ops/cuda_kernels.row_fragments), both NULL
// unless the rescore is certified; rescore SK_CERTIFIED (2: "high",
// "highest", "mixed") or SK_BF16 (1: "default", lossy); out (n,) int32;
// band_pairs one uint64 counter, flags one int32 per pair-list entry and
// rescored_pairs one uint64 counter (the pairs the certified rescore
// decided exactly), all zeroed by the caller (any may be NULL).  Returns
// the cudaError_t of the launch.
int pp_count_pairs_sketch(const float* pts, const float* slab,
                          const int* mask, const int* row_ptr,
                          const int* cols, const float* centers,
                          const float* rows, const void* xfrag, float eps2,
                          float band, long long n, int d, int skp, int k,
                          int tile, int nt, int rescore, int* out,
                          unsigned long long* band_pairs, int* flags,
                          unsigned long long* rescored_pairs, void* stream) {
  return launch<0>(pts, slab, mask, row_ptr, cols, centers, rows, xfrag, eps2,
                   band, n, d, skp, k, tile, nt, rescore, out, band_pairs,
                   flags, rescored_pairs, nullptr, nullptr, stream);
}

// B4: per-point minimum source label within eps through the sketch gate
// (labels INT32_MAX for non-source points).  Same layout as B3, with
// rescore SK_EXACT (0: "high", "highest", "mixed"; centers unused) or
// SK_BF16 (1: "default", centers over the row mask), plus tile_min (nt,)
// int32, the minimum label of each tile, and evaluated, NULL or one uint64
// counter, zeroed by the caller, to which the kernel adds the (block,
// chunk) pairs it evaluated.
int pp_minlab_pairs_sketch(const float* pts, const float* slab,
                           const int* labels, const int* row_ptr,
                           const int* cols, const float* centers,
                           float eps2, float band, long long n, int d,
                           int skp, int k, int tile, int nt, int rescore,
                           int* out, const int* tile_min,
                           unsigned long long* evaluated, void* stream) {
  return launch<1>(pts, slab, labels, row_ptr, cols, centers, nullptr,
                   nullptr, eps2,
                   band, n, d, skp, k, tile, nt, rescore, out, nullptr, nullptr,
                   nullptr, tile_min, evaluated, stream);
}

// The tensor cores' accumulation probe (sk_mma_probe_kernel): batch
// blocks of a (batch, 16, K) and b (batch, 8, K) bfloat16, K a positive
// multiple of 16, into out (batch, 16, 8) float32.  Returns the
// cudaError_t of the launch.
int pp_mma_dot_probe(const void* a, const void* b, int batch, int K,
                     float* out, void* stream) {
  if (batch <= 0) return 0;
  if (K <= 0 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  sk_mma_probe_kernel<<<batch, 32, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(a),
      reinterpret_cast<const __nv_bfloat16*>(b), K, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
