// Eps-neighbourhood pair kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU's Pallas kernels _count_pairs_kernel (B1) and
// _minlab_pairs_kernel (B2) in pypardis_tpu/ops/pallas_kernels.py.  Both
// walk the live tile-pair list of a fit (built once per fit by
// ops/distances.live_tile_pairs and handed over as CSR row offsets plus
// the column-tile ids) and reduce, for every point, over the points of
// its row tile's live column tiles:
//   B1 (MODE 0): count of columns j with colval[j] != 0 and d2 <= eps2;
//   B2 (MODE 1): min colval[j] over columns with d2 <= eps2, where
//                non-source columns carry INT32_MAX.
// Which kernel runs: B1 at d <= 64 runs b1_tc_kernel (the tensor cores,
// every mode; at the end of this file); past 64 axes slice_kernel<0>
// ("high") or fast_pair_kernel<0, *, 0>.  B2 runs minlab_kernel ("high",
// d <= 64), slice_kernel<1> (past 64 axes) or fast_pair_kernel<1, *, *>
// ("mixed", "default").
//
// Design.  The TPU grid ran the pair list in order and carried each
// row's accumulator from one grid step to the next; Hopper's blocks run
// in no order, so here one block owns a slice of one row tile and loops
// over that tile's live column tiles itself, keeps each row's count or
// minimum in registers and writes its rows once.  No atomics on the
// outputs, no inter-block reduction, deterministic.  Rows whose tile has
// no live pair get the identity (0 or INT32_MAX).  In the FP32 kernels
// (minlab_kernel, slice_kernel) each thread owns one output row, keeps
// its coordinates in registers (d <= 64; past that the axis slices
// below) and reads each staged column point as float4 broadcasts from
// shared memory.
//
// The exact d^2 is (x_a - y_a)^2 summed over the axes in index order with
// __fsub_rn/__fmul_rn/__fadd_rn, so no multiply-add is contracted: the
// plain PyTorch version (ops/distances._pair_d2) repeats the same
// operations and is bitwise equal to every exact verdict here on any
// data.
//
// Bound of the FP32 kernels.  Per pair of points 3d FP32 SIMT operations
// and a compare; the bytes are the coordinates once, so they are bound by
// FP32 SIMT issue.  The arithmetic is unfused, one FP32 instruction per
// operation, so the SIMT ceiling is half the card's FFMA-counted 67
// TFLOP/s.  B2 skips most pairs (below): its floor is the pairs a
// label-exact method must still rule out.
//
// B1 on the tensor cores (b1_tc_kernel, d <= 64, "high", "highest",
// "mixed" and "default").  A block of up to B1_WARPS warps owns 16 MT rows
// per warp of one row tile (MT = 4 at K = 16: 512 rows, two blocks per
// 1,024-row tile) and holds their A fragments in registers: bf16(x - c),
// c the row tile's box centre (any point would do), K = d padded to 16.
// Per pair-list entry it stages the column tile once per block, in slabs
// of up to 512 columns, one column per thread: Y' = bf16(y - c) (stride
// K + 8 halves: conflict-free B fragments), the FP32 y (zero-padded to K),
// |Y|^2 (an axis-ordered _rn sum; +inf for an invalid column) and, per
// 32 columns, the maxima over valid columns of |Y|^2, |Y'|^2 and
// |Y' - Y|^2.  Each warp then runs mma.sync m16n8k16 over its rows and
// the slab, 64 columns (one band chunk) at a time, each B fragment
// feeding MT mma, and takes per pair t = fl(|Y|^2 - 2 dot) (one fused
// multiply-add: 2 dot is exact).  The pair's d2f is |X|^2 + t in real
// arithmetic: each row's bounds on t absorb |X|^2, rounded outward, so a
// test on t is the test on that real sum.  Then:
//   * "default": count when |X|^2 + t <= eps2 (lossy, as on the TPU);
//   * "high", "highest" and "mixed": with band b of the row against the
//     chunk (below), count when |X|^2 + t < eps2 - b; drop when |X|^2 + t
//     > eps2 + b; anything else (NaN included) is undecided, a bit in
//     the lane's registers.  After the chunk the warp's undecided pairs
//     with valid columns go to the exact fallback: the lanes take them
//     two at a time (found by a binary search of shuffles over the lanes'
//     inclusive counts and a select in the owner's bits) and decide them
//     with the exact d^2 above from the block's FP32 copies of its rows
//     and of the slab in shared memory, adding to a per-row count there.
//     So the counts are bitwise counts_over_pairs' on every row, valid or
//     not, as long as b bounds |d2f - E|, E the exact d^2.
//     `rescored_pairs` (optional) counts the pairs the fallback decided.
//   * "mixed" also counts, over the same t, the JAX stats of the
//     reference band: per entry bt_band at the row tile's rnorm and the
//     maxima of |y - c| and |y| over the entry's valid columns (taken
//     from the slab's maxima, or by a sweep of the column tile before its
//     first slab when the tile is wider than one slab), its test |d2f -
//     eps2| <= band as bounds on t per row; band_pairs counts the pairs
//     of valid rows and columns in it and flags the entries holding one.
//     Its counts are the certified ones, so bitwise "high"'s.
// The band.  sketch_kernels.cu's header derives, for one pair, the band
// band_p = c_cross (|X' - X| |Y'| + |X| |Y' - Y|) + c_acc |X'| |Y'|
//          + c_norm (|X|^2 + |Y|^2) + 2^-100
// (ops/distances.certified_band_coefs) and proves |d2f - E| <= band_p for
// d2f = fl(fl(|X|^2 + |Y|^2) - 2 dot); its term (4) bounds the rounding
// after the cross term by 4 u S, which covers t's single rounding
// (u |yy - 2 dot| <= (2 + 2^-6) u S), so band_p bounds |(|X|^2 + t) - E|
// as well.  Here one band serves a row and a chunk of 64 columns: every
// term is non-negative and increasing in the column's |Y|^2, |Y'| and
// |Y' - Y|, so band_p at the chunk's maxima of these over its valid
// columns bounds every pair of the chunk.  The kernel evaluates it as
// alpha YH + beta YE + c_norm YY + delta, with the row's alpha = fl(c_cross
// |X' - X| + c_acc |X'|), beta = fl(c_cross |X|), delta = fl(c_norm |X|^2 +
// 2^-100) and three fused multiply-adds: each term passes through at most
// six roundings to nearest, each a factor of at least 1 - u, within the
// seven the derivation allows for the band's own arithmetic (sqrt_rn of
// the maxima equals the maximum of the roots: rounding is monotone).
// lo = eps2 - band is rounded down and hi = eps2 + band up, and the bounds
// on t, lo - |X|^2 up and hi - |X|^2 down: a test on the float t against
// them holds exactly when it holds for the real sum.  The emulation
// ops/distances.certified_count_walk takes the same steps
// (b1_chunk_band).  A band per pair would leave fewer pairs undecided
// but costs the epilogue its evaluation per pair, where the chunk's is
// paid once per row and 64 columns.
// The tests (tests/test_torch_b1_certified.py) hold the chunk band over
// random and near-eps pairs at K = 16, 32 and 64 in float64, and
// chip_smoke.py holds the tensor cores' accumulation to term (3) at K =
// 16, 64 and 512.
//
// Bound of the tensor-core B1.  Per pair 2 K tensor-core operations and
// the epilogue's FP32 operations (t: 2; the two tests: 2; "mixed"'s stats
// test: 2 more; "default": one test), plus 3 d + 1 per undecided pair in
// the exact fallback; the bytes (coordinates, CSR) are far below.  At
// 1M x 16-D the epilogue is the larger, so the kernel is bound by issue
// in the epilogue and by the fallback's latency.  What the design does:
// one staging and conversion of each column per block (the bf16 pass
// before it restaged and reconverted every 64 columns for each block of
// 128 rows), MT mma per B fragment, verdicts as predicated instructions
// in inline PTX (the compiler made a divergent branch of each pair's
// verdict written in C), no skip of a single n-tile (a branch there kept
// the compiler from overlapping one n-tile's mma with the last one's
// epilogue), the exact fallback's operands in shared memory as float4s
// with their loads issued before the serial sum (an axis at a time from
// global memory cost a load's latency per axis), two pairs per lane
// per round, and two columns per thread in the staging.  Its times,
// bound, floor and undecided share at 1M x 16-D: chip_smoke.py --b1 and
// PERF.md.
//
// Precision modes of B2 and of B1 past 64 axes (fast_pair_kernel below).
// Under "mixed" and "default" the TPU kernels run _mixed_classify / a
// single bf16 dot; here:
//   * one block owns 128 rows of a row tile (8 warps x 16 rows) and walks
//     the same CSR list; each column chunk of 64 is staged in shared memory
//     as bf16, recentred on the row tile's box centre (the tile routine of
//     bf16_tile.cuh); each warp runs mma.sync m16n8k16 over its 16 rows x
//     64 columns (K = d padded to 16; d <= 64 keeps its A fragments in
//     registers for the whole block, d > 64 runs K slices of 64 and reads
//     A from global memory) and takes d2f in the epilogue;
//   * "default": the verdict is d2f <= eps2;
//   * "mixed": per pair-list entry the band is bt_band at the row tile's
//     norm maxima (rnorm, over its valid rows) and the entry's valid (B1)
//     or source (B2) columns' maxima of |y - c| and |y|, found by a sweep
//     over the column tile before its chunks; a pair with
//     |d2f - eps2| <= band and a valid column goes to a per-warp queue in
//     shared memory, and at the end of the chunk the warp's lanes take the
//     queued pairs one each and decide them with the exact arithmetic
//     above (the rows and columns staged in FP32 for d <= 64, read from
//     global memory beyond), adding to a per-row count (or minimum) in
//     shared memory.
// The band is sound for every valid row (band_halfwidth bounds the bf16
// error of the cross term, exact_slack the FP32 rounding of the exact
// pass), so counts and labels equal the FP32 kernel's on valid rows.  B1
// also counts the in-band pairs of valid rows and columns (one 64-bit
// counter) and flags each pair-list entry holding one.  Rows outside the
// row mask the frames were taken over carry no guarantee (the callers
// mask them, as on the TPU).  Bound: 2 K tensor-core operations per pair
// and about ten FP32 epilogue operations, plus the in-band pairs' exact
// d^2.
//
// Axis slices.  Past 64 axes the row no longer fits in registers, and
// past 58,108 one staged column of d floats would not fit the card's
// opt-in 227 KB of shared memory, so B1 and B2 under "high" stage chunks
// of 32 columns one slice of PP_SLICE axes at a time (slice_kernel): each
// row keeps its partial d^2 per staged column in registers across the
// slices, so every column's sum still runs over the axes in index order
// with the same _rn operations and stays bitwise _pair_d2, at any d;
// each row value is read once per four axes per 32-column chunk, so the
// slices also pay below 58,108 axes (PERF.md).
//
// B2's label-bound skip (every mode; B1 counts every pair).  B2's output
// is a minimum, so most of its pairs cannot change it (the rule of B4,
// csrc/sketch_kernels.cu):
//   - row r keeps a running minimum m_r from INT32_MAX (never from its
//     own label: under "default" the bf16 self-pair verdict can miss);
//   - L_C, the least column value of a 32-column chunk C (INT32_MAX when C
//     holds no source), bounds every label C can give r from below, so if
//     L_C >= m_r, skipping C leaves r's minimum unchanged whatever the
//     verdicts inside C;
//   - a block passes over C when L_C >= its bound, the max of m_r over
//     its live rows, and over a whole pair-list entry when its column
//     tile's least label (the wrapper's (nt,) tile_min) is >= the bound
//     (no staging, and under "mixed" no band sweep).  The rule never
//     looks at a distance, so it is exact in every mode.
// Each warp reads a chunk's labels itself and takes a __reduce_min_sync
// (lb_find, label_bound.cuh), so a passed-over chunk costs no barrier and
// the search is uniform over the block.  The block stages up to a group
// of chunks it will evaluate (cp.async, in flight while the search goes
// on) per barrier pair; the bound is refreshed at the barrier that opens
// each group (a __reduce_max_sync per warp, a max over the warps in
// shared memory).  The group is fixed per kernel instance
// (ops/distances.minlab_group): under "high" PP_GROUP chunks, or as many
// as fit 48 KB of shared memory (five at d <= 64), one on the axis-sliced
// path; FP_GROUP, two, in the bf16 kernel's 64-column buffer.
// Inside a staged chunk a warp whose own max of m_r is <= L_C skips it;
// the FP32 kernel also skips each column whose label is >= that max, and
// the bf16 kernel queues an in-band pair for the exact rescore only if
// its label is below the row's minimum.  Under "mixed" an evaluated
// chunk's band is still the one from its entry's full column sweep, so
// every verdict, and with it the output, is bitwise the plain version's.
// `evaluated` (optional) counts the (block, chunk) pairs evaluated;
// ops/distances.minlab_pairs_walk is the same walk in plain torch.
// The staged widths were measured, not assumed: PERF.md gives the times
// of chip_smoke.py --b2 on copies of this file with PP_GROUP and FP_GROUP
// set to other values.  Neither kernel copies a chunk while another is
// evaluated: B4's double buffer measured 11-12 % slower.
//
// Rows that never fall.  A row with no source within eps keeps m_r =
// INT32_MAX and would pin its block's bound there, so that the block
// skips nothing.  At 16-D such rows are common: noise, and the pad slots
// of the segment-break layout (zeros at the data's centre at the tail of
// every segment).  So the caller may pass live_rows, the rows it still
// needs; the others leave the bound and are written INT32_MAX.  The fit
// (ops/labels.dbscan_fixed_size) passes its valid rows, and after a
// pass only those that pass found a source for.  That is exact: the
// sources (the core mask), the pair list and with them every verdict are
// the same in each of the fit's passes, so a row without a source within
// eps in one pass has none in the next, and the fit reads no pad row's
// answer (it masks them through core and finish_labels).  The plain
// versions take the same live_rows and do the same.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_tile.cuh"
#include "label_bound.cuh"
#include "ppt_check.cuh"

#define PP_INT_INF 2147483647
#define PP_INT_MIN (-PP_INT_INF - 1)
#define PP_THREADS 256
#define PP_WARPS (PP_THREADS / 32)
#define PP_MAX_CHUNK 256
#define PP_SMEM_BYTES 49152
#define PP_CHUNK LB_CHUNK    // columns per chunk of B2's walk
#define PP_GROUP 8           // chunks B2 stages per barrier ("high"), at most
#define PP_SLICE 380         // axes per slice: 32 x 380 floats + labels < 48 KB

// Chunks minlab_kernel<DC> stages per barrier: PP_GROUP, or as many as
// fit 48 KB (DC = 64: five).
__host__ __device__ constexpr int pp_group(int dc) {
  return PP_SMEM_BYTES / (4 * (dc + 1) * PP_CHUNK) < PP_GROUP
             ? PP_SMEM_BYTES / (4 * (dc + 1) * PP_CHUNK)
             : PP_GROUP;
}

__device__ __forceinline__ void pp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// The block's bound: the max over its warps' largest running minima.
__device__ __forceinline__ int pp_bound(const int* warp_max, int nw) {
  int b = warp_max[0];
  for (int i = 1; i < nw; ++i) b = max(b, warp_max[i]);
  return b;
}

// d^2 of the row in registers (xr, DC axes, zeros past d) against one
// staged column y (dp floats, zeros past d): axis-ordered, unfused.
template <int DC>
__device__ __forceinline__ float pp_d2_regs(const float* xr, const float* y,
                                            int d) {
  float d2 = 0.f;
#pragma unroll
  for (int q = 0; q < DC / 4; ++q) {
    if (4 * q < d) {
      const float4 y4 = reinterpret_cast<const float4*>(y)[q];
      float df = __fsub_rn(xr[4 * q + 0], y4.x);
      d2 = __fadd_rn(d2, __fmul_rn(df, df));
      df = __fsub_rn(xr[4 * q + 1], y4.y);
      d2 = __fadd_rn(d2, __fmul_rn(df, df));
      df = __fsub_rn(xr[4 * q + 2], y4.z);
      d2 = __fadd_rn(d2, __fmul_rn(df, df));
      df = __fsub_rn(xr[4 * q + 3], y4.w);
      d2 = __fadd_rn(d2, __fmul_rn(df, df));
    }
  }
  return d2;
}

// B2 under "high"/"highest" at d <= 64 (DC = d rounded up to 4, 8, 16,
// 32 or 64): the label-bound walk of the header, up to pp_group(DC)
// chunks of 32 columns staged per barrier pair, the row in registers.
template <int DC>
__global__ void __launch_bounds__(PP_THREADS) minlab_kernel(
    const float* __restrict__ pts, const int* __restrict__ colval,
    const int* __restrict__ row_ptr, const int* __restrict__ cols,
    float eps2, long long n, int d, int tile,
    const int* __restrict__ tile_min, const unsigned char* __restrict__ live,
    int* __restrict__ out, unsigned long long* __restrict__ evaluated) {
  constexpr int G = pp_group(DC);
  extern __shared__ float4 smem4[];
  const int dp = (d + 3) & ~3;
  float* ys = reinterpret_cast<float*>(smem4);  // G * 32 columns x dp
  int* sv = reinterpret_cast<int*>(ys + (size_t)G * PP_CHUNK * dp);
  __shared__ int warp_max[PP_WARPS];
  __shared__ int chunk_min[G];

  const int r = blockIdx.x;
  const int local = blockIdx.y * PP_THREADS + threadIdx.x;
  const bool active = local < tile;
  const long long row = (long long)r * tile + (active ? local : 0);
  const bool inb = active && (live == nullptr || live[row] != 0);
  const int lane = threadIdx.x & 31;

  float xr[DC];
#pragma unroll
  for (int a = 0; a < DC; ++a) xr[a] = a < d ? pts[a * n + row] : 0.f;

  int m = PP_INT_INF;
  const int p1 = row_ptr[r + 1];
  int p = row_ptr[r], j0 = 0;
  unsigned long long n_eval = 0;
  bool more = true;
  while (more) {
    const int wm = __reduce_max_sync(0xffffffffu, inb ? m : PP_INT_MIN);
    if (lane == 0) warp_max[threadIdx.x >> 5] = wm;
    __syncthreads();  // the previous group is consumed, warp_max is set
    const int bnd = pp_bound(warp_max, PP_WARPS);
    int k = 0;
    while (k < G) {
      int L;
      if (!lb_find(colval, cols, tile_min, tile, p1, bnd, p, j0, L)) {
        more = false;
        break;
      }
      const long long col0 = (long long)__ldg(cols + p) * tile + j0;
      const int w = min(PP_CHUNK, tile - j0);
      if (threadIdx.x < PP_CHUNK) {
        int* dst = sv + k * PP_CHUNK + threadIdx.x;
        if (threadIdx.x < w)
          lb_cp4(dst, colval + col0 + threadIdx.x, 4);
        else
          *dst = PP_INT_INF;
      }
      // Coordinates, zero-filled past the tile and past d (+0 to d2).
      float* yk = ys + (size_t)k * PP_CHUNK * dp;
      for (int e = threadIdx.x; e < dp * PP_CHUNK; e += PP_THREADS) {
        const int a = e / PP_CHUNK;
        const int t = e - a * PP_CHUNK;
        const bool in = t < w && a < d;
        lb_cp4(yk + t * dp + a, in ? pts + a * n + col0 + t : pts,
               in ? 4 : 0);
      }
      if (threadIdx.x == 0) chunk_min[k] = L;
      ++k;
      j0 += PP_CHUNK;
    }
    if (k == 0) break;
    pp_wait_all();
    __syncthreads();  // the group is staged
    n_eval += k;
    for (int c = 0; c < k; ++c) {
      // A chunk, or a column, no row of this warp can fall by is skipped
      // (uniform over the warp).
      const int wc = __reduce_max_sync(0xffffffffu, inb ? m : PP_INT_MIN);
      if (wc <= chunk_min[c] || !inb) continue;
      for (int t = 0; t < PP_CHUNK; ++t) {
        const int v = sv[c * PP_CHUNK + t];
        if (v >= wc) continue;
        const float d2 =
            pp_d2_regs<DC>(xr, ys + (size_t)(c * PP_CHUNK + t) * dp, d);
        if (d2 <= eps2) m = min(m, v);
      }
    }
  }
  if (active) {
    PPT_CHECK(row, n);
    out[row] = inb ? m : PP_INT_INF;
  }
  if (evaluated && threadIdx.x == 0 && n_eval) atomicAdd(evaluated, n_eval);
}

// The axis-sliced path: chunks of 32 columns staged PP_SLICE axes at a
// time, each row's 32 partial d^2 in registers across the slices (the
// axis order of every column's sum is kept), past 64
// axes (B1, MODE 0; B2, MODE 1, with the label-bound walk of the header,
// one chunk per group) under "high".
template <int MODE>
__global__ void __launch_bounds__(PP_THREADS) slice_kernel(
    const float* __restrict__ pts, const int* __restrict__ colval,
    const int* __restrict__ row_ptr, const int* __restrict__ cols,
    float eps2, long long n, int d, int tile, int sa,
    const int* __restrict__ tile_min, const unsigned char* __restrict__ live,
    int* __restrict__ out, unsigned long long* __restrict__ evaluated) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);  // 32 columns x sa axes
  int* sv = reinterpret_cast<int*>(ys + (size_t)PP_CHUNK * sa);
  __shared__ int warp_max[PP_WARPS];

  const int r = blockIdx.x;
  const int local = blockIdx.y * PP_THREADS + threadIdx.x;
  const bool active = local < tile;
  const long long row = (long long)r * tile + (active ? local : 0);
  const bool inb = active && (MODE == 0 || live == nullptr || live[row] != 0);
  const int lane = threadIdx.x & 31;
  const int inval = MODE == 0 ? 0 : PP_INT_INF;

  int acc = MODE == 0 ? 0 : PP_INT_INF;
  const int p1 = row_ptr[r + 1];
  int p = row_ptr[r], j0 = 0;
  unsigned long long n_eval = 0;
  while (true) {
    int L = PP_INT_MIN;
    if (MODE == 1) {
      const int wm = __reduce_max_sync(0xffffffffu, inb ? acc : PP_INT_MIN);
      if (lane == 0) warp_max[threadIdx.x >> 5] = wm;
      __syncthreads();  // warp_max is set
      if (!lb_find(colval, cols, tile_min, tile, p1,
                   pp_bound(warp_max, PP_WARPS), p, j0, L))
        break;
      ++n_eval;
    } else if (p >= p1) {
      break;
    }
    const long long col0 = (long long)cols[p] * tile + j0;
    const int w = min(PP_CHUNK, tile - j0);
    // A chunk no row of this warp can fall by is skipped (B2).
    const int wc =
        MODE == 1 ? __reduce_max_sync(0xffffffffu, inb ? acc : PP_INT_MIN)
                  : 0;
    const bool go = inb && (MODE == 0 || wc > L);
    float part[PP_CHUNK];
#pragma unroll
    for (int t = 0; t < PP_CHUNK; ++t) part[t] = 0.f;
    for (int s0 = 0; s0 < d; s0 += sa) {
      const int as = min(sa, d - s0);
      __syncthreads();  // the previous slice (or chunk) is consumed
      if (s0 == 0 && threadIdx.x < PP_CHUNK)
        sv[threadIdx.x] = threadIdx.x < w ? colval[col0 + threadIdx.x] : inval;
      // Axes past d (and columns past the tile) hold 0 on both sides.
      for (int e = threadIdx.x; e < sa * PP_CHUNK; e += PP_THREADS) {
        const int a = e / PP_CHUNK;
        const int t = e - a * PP_CHUNK;
        ys[t * sa + a] =
            t < w && a < as ? pts[(long long)(s0 + a) * n + col0 + t] : 0.f;
      }
      __syncthreads();
      if (!go) continue;
      for (int a = 0; a < as; a += 4) {
        float x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] = s0 + a + i < d ? __ldg(pts + (long long)(s0 + a + i) * n + row)
                                : 0.f;
#pragma unroll
        for (int t = 0; t < PP_CHUNK; ++t) {
          const float4 y4 = *reinterpret_cast<const float4*>(ys + t * sa + a);
          float df = __fsub_rn(x[0], y4.x);
          part[t] = __fadd_rn(part[t], __fmul_rn(df, df));
          df = __fsub_rn(x[1], y4.y);
          part[t] = __fadd_rn(part[t], __fmul_rn(df, df));
          df = __fsub_rn(x[2], y4.z);
          part[t] = __fadd_rn(part[t], __fmul_rn(df, df));
          df = __fsub_rn(x[3], y4.w);
          part[t] = __fadd_rn(part[t], __fmul_rn(df, df));
        }
      }
    }
    if (go) {
#pragma unroll
      for (int t = 0; t < PP_CHUNK; ++t) {
        const int v = sv[t];
        if (v != inval && part[t] <= eps2)
          acc = MODE == 0 ? acc + 1 : min(acc, v);
      }
    }
    j0 += PP_CHUNK;
    if (MODE == 0 && j0 >= tile) {
      j0 = 0;
      ++p;
    }
  }
  if (active) out[row] = inb ? acc : PP_INT_INF;
  if (MODE == 1 && evaluated && threadIdx.x == 0 && n_eval)
    atomicAdd(evaluated, n_eval);
}

template <int MODE>
static int slice_launch(const float* pts, const int* colval,
                        const int* row_ptr, const int* cols, float eps2,
                        long long n, int d, int tile, int nt,
                        const int* tile_min, const unsigned char* live,
                        int* out, unsigned long long* evaluated,
                        cudaStream_t s) {
  const int sa = min(PP_SLICE, (d + 3) & ~3);
  const size_t smem = (size_t)PP_CHUNK * sa * 4 + PP_CHUNK * 4;
  const dim3 grid(nt, (tile + PP_THREADS - 1) / PP_THREADS);
  slice_kernel<MODE><<<grid, PP_THREADS, smem, s>>>(
      pts, colval, row_ptr, cols, eps2, n, d, tile, sa, tile_min, live, out,
      evaluated);
  return (int)cudaGetLastError();
}

template <int DC>
static int minlab_launch_dc(dim3 grid, cudaStream_t s, const float* pts,
                            const int* colval, const int* row_ptr,
                            const int* cols, float eps2, long long n, int d,
                            int tile, const int* tile_min,
                            const unsigned char* live, int* out,
                            unsigned long long* evaluated) {
  // At most 48 KB: pp_group(DC) chunks of DC + 1 words per column.
  const size_t smem =
      (size_t)pp_group(DC) * PP_CHUNK * (((d + 3) & ~3) + 1) * 4;
  minlab_kernel<DC><<<grid, PP_THREADS, smem, s>>>(
      pts, colval, row_ptr, cols, eps2, n, d, tile, tile_min, live, out,
      evaluated);
  return (int)cudaGetLastError();
}

static int minlab_launch(const float* pts, const int* colval,
                         const int* row_ptr, const int* cols, float eps2,
                         long long n, int d, int tile, int nt,
                         const int* tile_min, const unsigned char* live,
                         int* out, unsigned long long* evaluated,
                         void* stream) {
  if (nt <= 0 || tile <= 0) return 0;
  if (!tile_min) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d > 64)
    return slice_launch<1>(pts, colval, row_ptr, cols, eps2, n, d, tile, nt,
                           tile_min, live, out, evaluated, s);
  const dim3 grid(nt, (tile + PP_THREADS - 1) / PP_THREADS);
#define PP_MINLAB_DC(DC)                                                    \
  minlab_launch_dc<DC>(grid, s, pts, colval, row_ptr, cols, eps2, n, d,     \
                       tile, tile_min, live, out, evaluated)
  if (d <= 4) return PP_MINLAB_DC(4);
  if (d <= 8) return PP_MINLAB_DC(8);
  if (d <= 16) return PP_MINLAB_DC(16);
  if (d <= 32) return PP_MINLAB_DC(32);
  return PP_MINLAB_DC(64);
#undef PP_MINLAB_DC
}


// ---- precision modes: the bf16 tensor-core pass --------------------------

#define FP_THREADS 256
#define FP_WARPS 8
#define FP_ROWS 128            // 16 rows per warp
#define FP_CH 64               // columns per chunk: 8 n-tiles of 8
#define FP_NT 8
#define FP_KS 64               // axes per K slice (d > 64): 4 k-steps
#define FP_YS (FP_KS + 8)      // bf16 stride of a staged column
#define FP_QCAP (16 * FP_CH)   // a warp's queue holds all its pairs of a chunk
#define FP_GROUP (FP_CH / PP_CHUNK)  // chunks B2 stages per step: two slots

// Shared-memory layout of fast_pair_kernel (byte offsets).
struct FpSmem {
  size_t yb, ys, xs, ctr, yy, cv, racc, red, q, total;
};

__host__ __device__ inline FpSmem fp_smem(int d, int ks, int fast) {
  FpSmem s;
  size_t o = 0;
  s.yb = o;  o += (size_t)FP_CH * FP_YS * 2;           // bf16 columns
  s.ys = o;  o += (size_t)(ks > 0 ? d : FP_KS) * FP_CH * 4;  // FP32 columns
  s.xs = o;  if (ks > 0 && !fast) o += (size_t)d * FP_ROWS * 4;  // FP32 rows
  s.ctr = o; o += (size_t)((d + 3) & ~3) * 4;
  s.yy = o;  o += FP_CH * 4;
  s.cv = o;  o += FP_CH * 4;
  s.racc = o; o += FP_ROWS * 4;
  s.red = o; o += 4 * FP_WARPS * 4;  // two entries' column norm maxima
  s.q = o;   if (!fast) o += (size_t)FP_WARPS * FP_QCAP * 2;
  s.total = o;
  return s;
}

// MODE 0 counts (B1), 1 min labels (B2); FAST 0 "mixed", 1 "default";
// KS > 0: d <= 16 KS, A fragments in registers; KS == 0: d > 64, K slices.
// The 64 staged columns are two slots of 32: B1 fills them with one
// 64-column chunk of its entry, B2 with the (up to FP_GROUP) chunks its
// label-bound walk evaluates next (see the header).
template <int MODE, int FAST, int KS>
__global__ void __launch_bounds__(FP_THREADS) fast_pair_kernel(
    const float* __restrict__ pts, const int* __restrict__ colval,
    const int* __restrict__ row_ptr, const int* __restrict__ cols,
    const float* __restrict__ centers, const float* __restrict__ rnorm,
    float eps2, long long n, int d, int tile, int* __restrict__ out,
    unsigned long long* __restrict__ band_pairs, int* __restrict__ flags,
    const int* __restrict__ tile_min,
    const unsigned char* __restrict__ live,
    unsigned long long* __restrict__ evaluated) {
  extern __shared__ __align__(16) unsigned char fp_sm[];
  const FpSmem L = fp_smem(d, KS, FAST);
  __nv_bfloat16* yb = reinterpret_cast<__nv_bfloat16*>(fp_sm + L.yb);
  float* ys = reinterpret_cast<float*>(fp_sm + L.ys);
  float* xs = reinterpret_cast<float*>(fp_sm + L.xs);
  float* ctr = reinterpret_cast<float*>(fp_sm + L.ctr);
  float* yy = reinterpret_cast<float*>(fp_sm + L.yy);
  int* cv = reinterpret_cast<int*>(fp_sm + L.cv);
  int* racc = reinterpret_cast<int*>(fp_sm + L.racc);
  float* red = reinterpret_cast<float*>(fp_sm + L.red);
  unsigned short* queue = reinterpret_cast<unsigned short*>(fp_sm + L.q);
  __shared__ int warp_max[FP_WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r = blockIdx.x;
  const int rbase = blockIdx.y * FP_ROWS;
  const long long row0 = (long long)r * tile;
  const int inval = MODE == 0 ? 0 : PP_INT_INF;
  const int ident = MODE == 0 ? 0 : PP_INT_INF;
  const int p0 = row_ptr[r];
  const int p1 = row_ptr[r + 1];
  if (p0 == p1) {  // uniform over the block: no live pair, the identity
    for (int i = tid; i < FP_ROWS; i += FP_THREADS)
      if (rbase + i < tile) out[row0 + rbase + i] = ident;
    return;
  }
  const int lr0 = rbase + warp * 16 + g;  // tile-local rows of the fragments
  const int lr1 = lr0 + 8;
  const bool act0 = lr0 < tile;
  const bool act1 = lr1 < tile;
  // B2: the rows in the skip's bound (the live ones).
  const bool in0 = act0 && (live == nullptr || live[row0 + lr0] != 0);
  const bool in1 = act1 && (live == nullptr || live[row0 + lr1] != 0);

  for (int a = tid; a < d; a += FP_THREADS)
    ctr[a] = centers[(long long)r * d + a];
  for (int i = tid; i < FP_ROWS; i += FP_THREADS) racc[i] = ident;
  if (KS > 0 && !FAST) {
    for (int e = tid; e < d * FP_ROWS; e += FP_THREADS) {
      const int a = e / FP_ROWS;
      const int i = e - a * FP_ROWS;
      xs[e] = rbase + i < tile ? pts[a * n + row0 + rbase + i] : 0.f;
    }
  }
  __syncthreads();

  // The rows' recentred squared norms, axis by axis.
  float xx0 = 0.f, xx1 = 0.f;
  for (int a = 0; a < d; ++a) {
    if (act0) {
      const float df = __fsub_rn(__ldg(pts + a * n + row0 + lr0), ctr[a]);
      xx0 = __fadd_rn(xx0, __fmul_rn(df, df));
    }
    if (act1) {
      const float df = __fsub_rn(__ldg(pts + a * n + row0 + lr1), ctr[a]);
      xx1 = __fadd_rn(xx1, __fmul_rn(df, df));
    }
  }
  const bool rv0 = MODE == 0 && act0 && colval[row0 + lr0] != 0;
  const bool rv1 = MODE == 0 && act1 && colval[row0 + lr1] != 0;

  // A fragment values: (x - c) of a fragment row, 0 off the tile or past d.
  auto xv = [&](int lr, bool act, int a) -> float {
    return (act && a < d) ? __fsub_rn(__ldg(pts + a * n + row0 + lr), ctr[a])
                          : 0.f;
  };
  unsigned af[KS > 0 ? KS : 1][4];
  if (KS > 0) {
#pragma unroll
    for (int kk = 0; kk < (KS > 0 ? KS : 1); ++kk) {
      const int k0 = kk * 16 + t4 * 2;
      af[kk][0] = bt_pack(xv(lr0, act0, k0), xv(lr0, act0, k0 + 1));
      af[kk][1] = bt_pack(xv(lr1, act1, k0), xv(lr1, act1, k0 + 1));
      af[kk][2] = bt_pack(xv(lr0, act0, k0 + 8), xv(lr0, act0, k0 + 9));
      af[kk][3] = bt_pack(xv(lr1, act1, k0 + 8), xv(lr1, act1, k0 + 9));
    }
  }

  // "mixed": an entry's column norm maxima about this row tile's centre,
  // over its valid (B1) or source (B2) columns, into dst[0..2 warps).
  auto sweep = [&](int pe, float* dst) {
    const long long c0 = (long long)cols[pe] * tile;
    float m1 = 0.f, m2 = 0.f;
    for (int j = tid; j < tile; j += FP_THREADS) {
      if (colval[c0 + j] == inval) continue;
      float s1 = 0.f, s2 = 0.f;
      for (int a = 0; a < d; ++a) {
        const float y = __ldg(pts + a * n + c0 + j);
        const float df = __fsub_rn(y, ctr[a]);
        s1 = __fadd_rn(s1, __fmul_rn(df, df));
        s2 = __fadd_rn(s2, __fmul_rn(y, y));
      }
      m1 = fmaxf(m1, s1);
      m2 = fmaxf(m2, s2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      m2 = fmaxf(m2, __shfl_xor_sync(0xffffffffu, m2, o));
    }
    if (lane == 0) {
      dst[warp] = m1;
      dst[FP_WARPS + warp] = m2;
    }
  };
  // The band from a sweep's maxima (after a barrier).
  auto band_of = [&](const float* src) -> float {
    float m1 = src[0], m2 = src[FP_WARPS];
    for (int i = 1; i < FP_WARPS; ++i) {
      m1 = fmaxf(m1, src[i]);
      m2 = fmaxf(m2, src[FP_WARPS + i]);
    }
    return bt_band(rnorm[2 * r], __fsqrt_rn(m1), rnorm[2 * r + 1],
                   __fsqrt_rn(m2));
  };

  int acc0 = ident, acc1 = ident;
  unsigned n_band = 0;
  // One step: the two slots' columns [colA, colA + wA) and [colB, colB +
  // wB), their bands, and whether this warp evaluates each (B2's skip).
  // p is B1's entry (for its flags); mr0 / mr1 bound the rows' minima (B2
  // queues only the in-band pairs whose label is below them).
  auto run = [&](long long colA, int wA, long long colB, int wB, float bA,
                 float bB, bool goA, bool goB, int p, int mr0, int mr1) {
    auto col_of = [&](int t) -> long long {
      return t < 32 ? colA + t : colB + (t - 32);
    };
    auto in_slot = [&](int t) -> bool { return t < 32 ? t < wA : t - 32 < wB; };
    float acc[FP_NT][4];
#pragma unroll
    for (int j = 0; j < FP_NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const int dk = KS > 0 ? d : FP_KS;
    for (int s0 = 0; s0 < (KS > 0 ? 1 : d); s0 += FP_KS) {
      const int as = KS > 0 ? d : min(FP_KS, d - s0);
      __syncthreads();  // the previous chunk (or slice) is consumed
      if (s0 == 0 && tid < FP_CH)
        cv[tid] = in_slot(tid) ? colval[col_of(tid)] : inval;
      const int kp = KS > 0 ? KS * 16 : FP_KS;
      for (int e = tid; e < kp * FP_CH; e += FP_THREADS) {
        const int a = e / FP_CH;
        const int t = e - a * FP_CH;
        const bool in = in_slot(t) && a < as;
        const float y = in ? __ldg(pts + (s0 + a) * n + col_of(t)) : 0.f;
        if (a < dk) ys[a * FP_CH + t] = y;
        yb[t * FP_YS + a] =
            __float2bfloat16_rn(in ? __fsub_rn(y, ctr[s0 + a]) : 0.f);
      }
      __syncthreads();
      if (tid < FP_CH) {  // the columns' recentred squared norms
        float sy = s0 == 0 ? 0.f : yy[tid];
        for (int a = 0; a < as; ++a) {
          const float df = __fsub_rn(ys[a * FP_CH + tid], ctr[s0 + a]);
          sy = __fadd_rn(sy, __fmul_rn(df, df));
        }
        yy[tid] = sy;
      }
#pragma unroll
      for (int kk = 0; kk < (KS > 0 ? KS : FP_KS / 16); ++kk) {
        unsigned a4[4];
        if (KS > 0) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a4[i] = af[KS > 0 ? kk : 0][i];
        } else {
          const int k0 = s0 + kk * 16 + t4 * 2;
          a4[0] = bt_pack(xv(lr0, act0, k0), xv(lr0, act0, k0 + 1));
          a4[1] = bt_pack(xv(lr1, act1, k0), xv(lr1, act1, k0 + 1));
          a4[2] = bt_pack(xv(lr0, act0, k0 + 8), xv(lr0, act0, k0 + 9));
          a4[3] = bt_pack(xv(lr1, act1, k0 + 8), xv(lr1, act1, k0 + 9));
        }
#pragma unroll
        for (int j = 0; j < FP_NT; ++j) {
          if (!(j < FP_NT / 2 ? goA : goB)) continue;  // uniform per warp
          const __nv_bfloat16* bp = yb + (j * 8 + g) * FP_YS + kk * 16 +
                                    t4 * 2;
          unsigned b[2];
          b[0] = *reinterpret_cast<const unsigned*>(bp);
          b[1] = *reinterpret_cast<const unsigned*>(bp + 8);
          bt_mma(acc[j], a4, b);
        }
      }
    }
    __syncthreads();  // yy of the last slice is written

    // The epilogue: the fast verdicts, and the in-band pairs queued.
    int qn = 0;
    bool had = false;
#pragma unroll
    for (int j = 0; j < FP_NT; ++j) {
      const bool go = j < FP_NT / 2 ? goA : goB;
      if (!go) continue;  // uniform per warp
      const float band = j < FP_NT / 2 ? bA : bB;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = j * 8 + t4 * 2 + (e & 1);
        const bool lo = e < 2;
        const float d2f = bt_d2f(lo ? xx0 : xx1, yy[cl], acc[j][e]);
        const int v = cv[cl];
        const bool valid = (lo ? act0 : act1) && v != inval;
        bool in = valid && d2f <= eps2;
        if (!FAST) {
          const bool amb = valid && fabsf(__fsub_rn(d2f, eps2)) <= band;
          in = in && !amb;
          // B2: a pair whose label cannot lower its row needs no rescore.
          const bool q = amb && (MODE == 0 || v < (lo ? mr0 : mr1));
          const unsigned m = __ballot_sync(0xffffffffu, q);
          if (q) {
            const int rl = (lo ? lr0 : lr1) - rbase;
            queue[warp * FP_QCAP + qn +
                  __popc(m & ((1u << lane) - 1u))] =
                (unsigned short)((rl << 6) | cl);
          }
          if (amb && (lo ? rv0 : rv1)) {
            ++n_band;
            had = true;
          }
          qn += __popc(m);
        }
        if (in) {
          if (lo)
            acc0 = MODE == 0 ? acc0 + 1 : min(acc0, v);
          else
            acc1 = MODE == 0 ? acc1 + 1 : min(acc1, v);
        }
      }
    }
    if (!FAST) {
      if (MODE == 0 && flags && __any_sync(0xffffffffu, had) && lane == 0)
        flags[p] = 1;
      __syncwarp();
      // The rescore: B1's exact d^2 for the queued pairs, one per lane.
      for (int i = lane; i < qn; i += 32) {
        const unsigned q = queue[warp * FP_QCAP + i];
        const int rl = (int)(q >> 6);
        const int cl = (int)(q & 63u);
        float d2 = 0.f;
        for (int a = 0; a < d; ++a) {
          const float xa = KS > 0 ? xs[a * FP_ROWS + rl]
                                  : __ldg(pts + a * n + row0 + rbase + rl);
          const float ya = KS > 0 ? ys[a * FP_CH + cl]
                                  : __ldg(pts + a * n + col_of(cl));
          const float df = __fsub_rn(xa, ya);
          d2 = __fadd_rn(d2, __fmul_rn(df, df));
        }
        if (d2 <= eps2) {
          if (MODE == 0)
            atomicAdd(racc + rl, 1);
          else
            atomicMin(racc + rl, cv[cl]);
        }
      }
      __syncwarp();
    }
  };

  unsigned long long n_eval = 0;
  if constexpr (MODE == 0) {  // one call of run per instance: inlined
    for (int p = p0; p < p1; ++p) {
      const long long c0 = (long long)cols[p] * tile;
      float band = 0.f;
      if (!FAST) {
        __syncthreads();  // the previous entry's maxima are read
        sweep(p, red);
        __syncthreads();
        band = band_of(red);
      }
      for (int j0 = 0; j0 < tile; j0 += FP_CH) {
        const int w = min(FP_CH, tile - j0);
        run(c0 + j0, min(32, w), c0 + j0 + 32, max(0, w - 32), band, band,
            true, true, p, 0, 0);
      }
    }
  } else {
    // B2's label-bound walk (see the header).
    int p = p0, j0 = 0;
    int band_p = -1;    // the entry whose band is band_v ("mixed")
    float band_v = 0.f;
    bool more = true;
    while (more) {
      // The rows' running minima, folded over the quads that hold them
      // and with their rescored pairs: every lane of a quad holds its
      // rows' minima (folding a minimum again changes nothing).
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        acc0 = min(acc0, __shfl_xor_sync(0xffffffffu, acc0, o));
        acc1 = min(acc1, __shfl_xor_sync(0xffffffffu, acc1, o));
      }
      acc0 = min(acc0, racc[lr0 - rbase]);
      if (act1) acc1 = min(acc1, racc[lr1 - rbase]);
      const int wm = __reduce_max_sync(
          0xffffffffu, max(in0 ? acc0 : PP_INT_MIN, in1 ? acc1 : PP_INT_MIN));
      if (lane == 0) warp_max[warp] = wm;
      __syncthreads();  // the previous step is consumed, warp_max is set
      const int bnd = pp_bound(warp_max, FP_WARPS);
      long long cA = 0, cB = 0;
      int wA = 0, wB = 0, LA = PP_INT_INF, LB = PP_INT_INF, pA = -1, pB = -1;
      int k = 0;
      while (k < FP_GROUP) {
        int Lc;
        if (!lb_find(colval, cols, tile_min, tile, p1, bnd, p, j0, Lc)) {
          more = false;
          break;
        }
        const long long col = (long long)__ldg(cols + p) * tile + j0;
        const int w = min(PP_CHUNK, tile - j0);
        if (k == 0) {
          cA = col; wA = w; LA = Lc; pA = p;
        } else {
          cB = col; wB = w; LB = Lc; pB = p;
        }
        ++k;
        j0 += PP_CHUNK;
      }
      if (k == 0) break;
      n_eval += k;
      float bA = 0.f, bB = 0.f;
      if (!FAST) {
        // The bands of the entries this step enters, each swept once.
        const bool newA = pA != band_p;
        const bool newB = k == 2 && pB != pA;
        if (newA || newB) {  // uniform
          if (newA) sweep(pA, red);
          if (newB) sweep(pB, red + 2 * FP_WARPS);
          __syncthreads();
        }
        bA = newA ? band_of(red) : band_v;
        bB = k < 2 ? 0.f : (newB ? band_of(red + 2 * FP_WARPS) : bA);
        band_p = k == 2 ? pB : pA;
        band_v = k == 2 ? bB : bA;
      }
      run(cA, wA, cB, k == 2 ? wB : 0, bA, bB, wm > LA, k == 2 && wm > LB,
          0, in0 ? acc0 : PP_INT_MIN, in1 ? acc1 : PP_INT_MIN);
    }
  }

  // Rows are spread over the four lanes of a quad: fold them, then add
  // the rescored pairs.
#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    const int u0 = __shfl_xor_sync(0xffffffffu, acc0, o);
    const int u1 = __shfl_xor_sync(0xffffffffu, acc1, o);
    acc0 = MODE == 0 ? acc0 + u0 : min(acc0, u0);
    acc1 = MODE == 0 ? acc1 + u1 : min(acc1, u1);
  }
  __syncwarp();
  if (t4 == 0) {
    const int ra = racc[lr0 - rbase];
    const int rb = act1 ? racc[lr1 - rbase] : ident;
    if (MODE == 0) {
      if (act0) out[row0 + lr0] = acc0 + ra;
      if (act1) out[row0 + lr1] = acc1 + rb;
    } else {
      if (act0) out[row0 + lr0] = in0 ? min(acc0, ra) : PP_INT_INF;
      if (act1) out[row0 + lr1] = in1 ? min(acc1, rb) : PP_INT_INF;
    }
  }
  if (MODE == 0 && !FAST && band_pairs) {
    unsigned long long v = n_band;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0 && v) atomicAdd(band_pairs, v);
  }
  if (MODE == 1 && evaluated && tid == 0 && n_eval)
    atomicAdd(evaluated, n_eval);
}

template <int MODE, int FAST, int KS>
static int fast_launch_ks(dim3 grid, cudaStream_t s, const float* pts,
                          const int* colval, const int* row_ptr,
                          const int* cols, const float* centers,
                          const float* rnorm, float eps2, long long n, int d,
                          int tile, int* out, unsigned long long* band_pairs,
                          int* flags, const int* tile_min,
                          const unsigned char* live,
                          unsigned long long* evaluated) {
  const size_t smem = fp_smem(d, KS, FAST).total;
  cudaError_t err = cudaFuncSetAttribute(
      fast_pair_kernel<MODE, FAST, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fast_pair_kernel<MODE, FAST, KS><<<grid, FP_THREADS, smem, s>>>(
      pts, colval, row_ptr, cols, centers, rnorm, eps2, n, d, tile, out,
      band_pairs, flags, tile_min, live, evaluated);
  return (int)cudaGetLastError();
}

template <int MODE, int FAST>
static int fast_launch(const float* pts, const int* colval,
                       const int* row_ptr, const int* cols,
                       const float* centers, const float* rnorm, float eps2,
                       long long n, int d, int tile, int nt, int* out,
                       unsigned long long* band_pairs, int* flags,
                       const int* tile_min, const unsigned char* live,
                       unsigned long long* evaluated, void* stream) {
  if (nt <= 0 || tile <= 0) return 0;
  if (!FAST && !rnorm) return (int)cudaErrorInvalidValue;
  if (MODE == 1 && !tile_min) return (int)cudaErrorInvalidValue;
  const dim3 grid(nt, (tile + FP_ROWS - 1) / FP_ROWS);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define PP_FAST_KS(KS)                                                      \
  fast_launch_ks<MODE, FAST, KS>(grid, s, pts, colval, row_ptr, cols,       \
                                 centers, rnorm, eps2, n, d, tile, out,     \
                                 band_pairs, flags, tile_min, live,         \
                                 evaluated)
  // B1 takes this kernel past 64 axes only (b1_tc_kernel below runs it
  // at d <= 64), so MODE 0 has no register-fragment instance.
  if constexpr (MODE == 1) {
    if (d <= 16) return PP_FAST_KS(1);
    if (d <= 32) return PP_FAST_KS(2);
    if (d <= 48) return PP_FAST_KS(3);
    if (d <= 64) return PP_FAST_KS(4);
  }
  return PP_FAST_KS(0);
#undef PP_FAST_KS
}



// ---- B1 on the tensor cores, d <= 64, every mode (see the header) ------

#define B1_WARPS 8      // warps per block, at most
#define B1_CH 64        // columns per band chunk: 8 n-tiles of 8
#define B1_EXACT 0      // "high"/"highest": certified verdicts, exact queue
#define B1_MIXED 1      // "mixed": the same, plus the reference band stats
#define B1_DEFAULT 2    // "default": the bf16 verdict d2f <= eps2 alone

// Row fragments per warp (the A fragments take MT * K / 4 registers) and
// columns staged per slab, so that two blocks' rows and slabs fit an SM's
// shared memory: 64 rows per warp and 512 columns at K = 16, 32 and 256
// at K = 32, 16 and 128 past that.
__host__ __device__ constexpr int b1_mt(int ks) {
  return ks == 1 ? 4 : ks == 2 ? 2 : 1;
}
__host__ __device__ constexpr int b1_slab_cap(int ks) {
  return ks == 1 ? 512 : ks == 2 ? 256 : 128;
}

// Shared-memory layout of b1_tc_kernel (byte offsets) for rb rows and a
// slab of cw columns.
struct B1Smem {
  size_t rowc, racc, ctr, yyv, hmax, vbits, red, xs, ys, yb, total;
};

__host__ __device__ inline B1Smem b1_smem(int ks, int rb, int cw, bool exact) {
  B1Smem s;
  size_t o = 0;
  s.rowc = o;  o += (size_t)rb * 16;                 // per row (a, b, c, |X|^2)
  s.racc = o;  o += (size_t)rb * 4;                  // exact verdicts in eps
  s.ctr = o;   o += (size_t)ks * 16 * 4;             // the row tile's centre
  s.yyv = o;   o += (size_t)cw * 4;                  // columns' |Y|^2 (+inf)
  s.hmax = o;  o += (size_t)(cw / 32) * 16;          // 32-column maxima
  s.vbits = o; o += (size_t)(cw / 32) * 4;           // column validity bits
  s.red = o;   o += 2 * B1_WARPS * 4;                // the sweep's maxima
  // The exact fallback's FP32 rows (K each) and columns (K + 4 each),
  // read as float4s: 16-byte aligned (the validity bits end off it when
  // cw is not a multiple of 128, as at a 64- or 192-row tile).
  o = (o + 15) & ~(size_t)15;
  s.xs = o;    if (exact) o += (size_t)rb * ks * 16 * 4;
  s.ys = o;    if (exact) o += (size_t)cw * (ks * 16 + 4) * 4;
  o = (o + 15) & ~(size_t)15;
  s.yb = o;    o += (size_t)cw * (ks * 16 + 8) * 2;  // bf16 Y', stride K + 8
  s.total = o;
  return s;
}

__device__ __forceinline__ float b1_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The per-pair verdicts, predicated (the compiler made branches of the
// plain C forms, one divergent branch per pair).  b1_cert: cnt += 1 if
// v < lo; amb |= bit unless v < lo or v > hi (a NaN is neither).
__device__ __forceinline__ void b1_cert(float v, float lo, float hi,
                                        unsigned bit, int& cnt,
                                        unsigned& amb) {
  asm("{\n\t.reg .pred pi, pd;\n\t"
      "setp.lt.f32 pi, %2, %3;\n\t"
      "setp.gt.or.f32 pd, %2, %4, pi;\n\t"
      "@pi add.s32 %0, %0, 1;\n\t"
      "@!pd or.b32 %1, %1, %5;\n\t}"
      : "+r"(cnt), "+r"(amb)
      : "f"(v), "f"(lo), "f"(hi), "r"(bit));
}

// cnt += 1 if v <= bound.
__device__ __forceinline__ void b1_count_le(float v, float bound, int& cnt) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.le.f32 p, %1, %2;\n\t"
      "@p add.s32 %0, %0, 1;\n\t}"
      : "+r"(cnt)
      : "f"(v), "f"(bound));
}

// cnt += 1 if lo <= v <= hi.
__device__ __forceinline__ void b1_count_in(float v, float lo, float hi,
                                            unsigned& cnt) {
  asm("{\n\t.reg .pred p, q;\n\t"
      "setp.ge.f32 p, %1, %2;\n\t"
      "setp.le.and.f32 q, %1, %3, p;\n\t"
      "@q add.u32 %0, %0, 1;\n\t}"
      : "+r"(cnt)
      : "f"(v), "f"(lo), "f"(hi));
}

// Max of v over the warp's lanes.
__device__ __forceinline__ float b1_wmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// B1 at d <= 64 (K = 16 KS): a block owns rb = 16 MT rows per warp of one
// row tile, holds their bf16 A fragments in registers and walks the row
// tile's pair-list entries, staging each column tile once per block in
// slabs of up to cw columns.  MODE: B1_EXACT, B1_MIXED or B1_DEFAULT.
template <int MODE, int KS, int MT>
__global__ void __launch_bounds__(B1_WARPS * 32, 2) b1_tc_kernel(
    const float* __restrict__ pts, const int* __restrict__ mask,
    const int* __restrict__ row_ptr, const int* __restrict__ cols,
    const float* __restrict__ centers, const float* __restrict__ rnorm,
    float eps2, long long n, int d, int tile, int cw, float c_cross,
    float c_acc, float c_norm, int* __restrict__ out,
    unsigned long long* __restrict__ band_pairs, int* __restrict__ flags,
    unsigned long long* __restrict__ rescored) {
  constexpr int K = KS * 16;
  constexpr int YS = K + 8;  // bf16 stride of a staged column
  constexpr int KP = K + 4;  // FP32 stride of a staged column
  const int nth = blockDim.x;
  const int nw = nth >> 5;
  const int rb = nw * 16 * MT;
  const B1Smem L = b1_smem(KS, rb, cw, MODE != B1_DEFAULT);
  extern __shared__ __align__(16) unsigned char b1_sm[];
  float4* rowc = reinterpret_cast<float4*>(b1_sm + L.rowc);
  int* racc = reinterpret_cast<int*>(b1_sm + L.racc);
  float* ctr = reinterpret_cast<float*>(b1_sm + L.ctr);
  float* yyv = reinterpret_cast<float*>(b1_sm + L.yyv);
  float* hmax = reinterpret_cast<float*>(b1_sm + L.hmax);
  unsigned* vbits = reinterpret_cast<unsigned*>(b1_sm + L.vbits);
  float* red = reinterpret_cast<float*>(b1_sm + L.red);
  float* xs = reinterpret_cast<float*>(b1_sm + L.xs);
  float* ys = reinterpret_cast<float*>(b1_sm + L.ys);
  __nv_bfloat16* yb = reinterpret_cast<__nv_bfloat16*>(b1_sm + L.yb);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int r = blockIdx.x;
  const int rbase = blockIdx.y * rb;
  const long long row0 = (long long)r * tile;
  const int p0 = row_ptr[r];
  const int p1 = row_ptr[r + 1];
  if (p0 == p1) {  // uniform over the block: no live pair, count 0
    for (int i = tid; i < rb; i += nth)
      if (rbase + i < tile) {
        PPT_CHECK(row0 + rbase + i, n);
        out[row0 + rbase + i] = 0;
      }
    return;
  }
  for (int a = tid; a < K; a += nth)
    ctr[a] = a < d ? centers[(long long)r * d + a] : 0.f;
  for (int i = tid; i < rb; i += nth) racc[i] = 0;
  __syncthreads();

  // Each row's recentred norms (axis-ordered _rn sums of X^2, X'^2 and
  // (X' - X)^2) and its band coefficients (see the header), one thread
  // per row; the exact modes also copy the row, zero-padded to K axes,
  // into xs (row-major: the exact fallback reads it as float4s).
  for (int i = tid; i < rb; i += nth) {
    const int lr = rbase + i;
    float xx = 0.f, h2 = 0.f, e2 = 0.f;
    float* xw = xs + i * K;
    if (MODE != B1_DEFAULT)
      for (int a = lr < tile ? d : 0; a < K; ++a) xw[a] = 0.f;
    if (lr < tile) {
      for (int a = 0; a < d; ++a) {
        const float x = __ldg(pts + a * n + row0 + lr);
        if (MODE != B1_DEFAULT) xw[a] = x;
        const float v = __fsub_rn(x, ctr[a]);
        const float vh = b1_bf16(v);
        const float ve = __fsub_rn(vh, v);
        xx = __fadd_rn(xx, __fmul_rn(v, v));
        h2 = __fadd_rn(h2, __fmul_rn(vh, vh));
        e2 = __fadd_rn(e2, __fmul_rn(ve, ve));
      }
    }
    rowc[i] = make_float4(
        __fadd_rn(__fmul_rn(c_cross, __fsqrt_rn(e2)),
                  __fmul_rn(c_acc, __fsqrt_rn(h2))),
        __fmul_rn(c_cross, __fsqrt_rn(xx)),
        __fadd_rn(__fmul_rn(c_norm, xx), 0x1p-100f), xx);
  }

  // The warp's A fragments: (x - c) of its rows rounded to bf16, 0 off
  // the tile and past d.
  const int wrow = warp * 16 * MT;
  auto xv = [&](int lr, int a) -> float {
    return (lr < tile && a < d)
               ? __fsub_rn(__ldg(pts + a * n + row0 + lr), ctr[a])
               : 0.f;
  };
  unsigned af[MT][KS][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int la = rbase + wrow + mt * 16 + g;
    const int lb = la + 8;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      const int k0 = kk * 16 + 2 * t4;
      af[mt][kk][0] = bt_pack(xv(la, k0), xv(la, k0 + 1));
      af[mt][kk][1] = bt_pack(xv(lb, k0), xv(lb, k0 + 1));
      af[mt][kk][2] = bt_pack(xv(la, k0 + 8), xv(la, k0 + 9));
      af[mt][kk][3] = bt_pack(xv(lb, k0 + 8), xv(lb, k0 + 9));
    }
  }
  __syncthreads();  // rowc is written

  // This lane's rows: (mt, h) is row wrow + 16 mt + 8 h + g of the block.
  // "default" counts a pair when |X|^2 + t <= eps2 in real arithmetic,
  // t = fl(|Y|^2 - 2 dot), that is when t <= thd = eps2 - |X|^2 rounded
  // down.
  float thd[MT][2];
  bool act[MT][2], rv[MT][2];
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int li = wrow + mt * 16 + h * 8 + g;
      act[mt][h] = rbase + li < tile;
      thd[mt][h] = act[mt][h] ? __fsub_rd(eps2, rowc[li].w) : -inf;
      rv[mt][h] = MODE == B1_MIXED && act[mt][h] &&
                  __ldg(mask + row0 + rbase + li) != 0;
    }

  int cnt[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) cnt[mt][0] = cnt[mt][1] = 0;
  unsigned n_band = 0;
  unsigned long long n_resc = 0;
  const int nslab = (tile + cw - 1) / cw;

  for (int p = p0; p < p1; ++p) {
    const long long c0 = (long long)__ldg(cols + p) * tile;
    // "mixed": the reference band of the entry, bt_band at the row tile's
    // rnorm and the maxima of |y - c| and |y| over its valid columns; a
    // tile wider than one slab is swept for them first.
    float bref = 0.f;
    if (MODE == B1_MIXED && nslab > 1) {
      float m1 = 0.f, m2 = 0.f;
      for (int j = tid; j < tile; j += nth) {
        if (__ldg(mask + c0 + j) == 0) continue;
        float s1 = 0.f, s2 = 0.f;
        for (int a = 0; a < d; ++a) {
          const float y = __ldg(pts + a * n + c0 + j);
          const float df = __fsub_rn(y, ctr[a]);
          s1 = __fadd_rn(s1, __fmul_rn(df, df));
          s2 = __fadd_rn(s2, __fmul_rn(y, y));
        }
        m1 = fmaxf(m1, s1);
        m2 = fmaxf(m2, s2);
      }
      m1 = b1_wmax(m1);
      m2 = b1_wmax(m2);
      __syncthreads();  // the previous entry's maxima are read
      if (lane == 0) {
        red[warp] = m1;
        red[B1_WARPS + warp] = m2;
      }
      __syncthreads();
      m1 = red[0];
      m2 = red[B1_WARPS];
      for (int i = 1; i < nw; ++i) {
        m1 = fmaxf(m1, red[i]);
        m2 = fmaxf(m2, red[B1_WARPS + i]);
      }
      bref = bt_band(rnorm[2 * r], __fsqrt_rn(m1), rnorm[2 * r + 1],
                     __fsqrt_rn(m2));
    }
    const unsigned band0 = n_band;  // "mixed": flag the entry if it grows
    for (int s = 0; s < nslab; ++s) {
      const int j0 = s * cw;
      const int w = min(cw, tile - j0);
      __syncthreads();  // the previous slab is consumed
      // Stage the slab, one column per thread: Y' in bf16, |Y|^2 (+inf
      // for an invalid column, so that d2f never counts it), and per 32
      // columns the maxima over valid columns of |Y|^2, |Y'|^2,
      // |Y' - Y|^2 and |y|^2, and the validity bits.
      // At K = 16 a thread stages two columns at once, all their loads
      // issued before the arithmetic (one column at a time paid two
      // loads' latencies per slab).
      constexpr int NCS = KS == 1 ? 2 : 1;
      for (int cs = tid; cs < cw; cs += NCS * nth) {
        float y[NCS][K];
#pragma unroll
        for (int u = 0; u < NCS; ++u) {
          const int c = cs + u * nth;
          const bool in = c < w;
#pragma unroll
          for (int a = 0; a < K; ++a)
            y[u][a] = in && a < d ? __ldg(pts + a * n + c0 + j0 + c) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < NCS; ++u) {
          const int c = cs + u * nth;
          if (c >= cw) break;  // uniform over the warp
          const bool valid = c < w && __ldg(mask + c0 + j0 + c) != 0;
          float yy = 0.f, h2 = 0.f, e2 = 0.f, gg = 0.f;
          unsigned* dst = reinterpret_cast<unsigned*>(yb + (size_t)c * YS);
          float4* yw = reinterpret_cast<float4*>(ys + c * KP);
#pragma unroll
          for (int a = 0; a < K; a += 4) {
            float Y[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              Y[i] = a + i < d ? __fsub_rn(y[u][a + i], ctr[a + i]) : 0.f;
              const float Yh = b1_bf16(Y[i]);
              const float Ye = __fsub_rn(Yh, Y[i]);
              yy = __fadd_rn(yy, __fmul_rn(Y[i], Y[i]));
              h2 = __fadd_rn(h2, __fmul_rn(Yh, Yh));
              e2 = __fadd_rn(e2, __fmul_rn(Ye, Ye));
              if (MODE == B1_MIXED)
                gg = __fadd_rn(gg, __fmul_rn(y[u][a + i], y[u][a + i]));
            }
            dst[a / 2] = bt_pack(Y[0], Y[1]);
            dst[a / 2 + 1] = bt_pack(Y[2], Y[3]);
            if (MODE != B1_DEFAULT)
              yw[a / 4] = make_float4(y[u][a], y[u][a + 1], y[u][a + 2],
                                      y[u][a + 3]);
          }
          yyv[c] = valid ? yy : inf;
          const float m0 = b1_wmax(valid ? yy : 0.f);
          const float m1 = b1_wmax(valid ? h2 : 0.f);
          const float m2 = b1_wmax(valid ? e2 : 0.f);
          const float m3 = MODE == B1_MIXED ? b1_wmax(valid ? gg : 0.f) : 0.f;
          const unsigned vb = __ballot_sync(0xffffffffu, valid);
          if (lane == 0) {
            *reinterpret_cast<float4*>(hmax + (c >> 5) * 4) =
                make_float4(m0, m1, m2, m3);
            vbits[c >> 5] = vb;
          }
        }
      }
      __syncthreads();  // the slab is staged
      if (MODE == B1_MIXED && nslab == 1) {
        float m1 = 0.f, m2 = 0.f;
        for (int i = 0; i < cw / 32; ++i) {
          m1 = fmaxf(m1, hmax[4 * i]);
          m2 = fmaxf(m2, hmax[4 * i + 3]);
        }
        bref = bt_band(rnorm[2 * r], __fsqrt_rn(m1), rnorm[2 * r + 1],
                       __fsqrt_rn(m2));
      }
      // The stats' test |d2f - eps2| <= bref as bounds on t per row (the
      // same test up to the rounding of |X|^2 + |Y|^2; none for an
      // invalid row, and an invalid column's t = +inf never meets them).
      float slo[MT][2], shi[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float xx = rowc[wrow + mt * 16 + h * 8 + g].w;
          slo[mt][h] = rv[mt][h] ? __fsub_rn(__fsub_rn(eps2, bref), xx) : inf;
          shi[mt][h] = rv[mt][h]
                           ? fminf(__fsub_rn(__fadd_rn(eps2, bref), xx),
                                   0x1.fffffep127f)
                           : -inf;
        }

      for (int ch = 0; ch * B1_CH < w; ++ch) {
        const unsigned v0 = vbits[2 * ch];
        const unsigned v1 = vbits[2 * ch + 1];
        if (!(v0 | v1)) continue;  // uniform: no valid column
        // The certified band of each row against this chunk: the band of
        // the header at the chunk's maxima, evaluated by three fused
        // multiply-adds; lo = eps2 - band and hi = eps2 + band rounded
        // outward, and the bounds on t (|X|^2 + t < lo, > hi) rounded so
        // that each test on t is the test on the real sum.
        float lo[MT][2], hi[MT][2];
        if (MODE != B1_DEFAULT) {
          const float4 ha = *reinterpret_cast<const float4*>(hmax + 8 * ch);
          const float4 hb =
              *reinterpret_cast<const float4*>(hmax + 8 * ch + 4);
          const float YY = fmaxf(ha.x, hb.x);
          const float YH = __fsqrt_rn(fmaxf(ha.y, hb.y));
          const float YE = __fsqrt_rn(fmaxf(ha.z, hb.z));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 rc = rowc[wrow + mt * 16 + h * 8 + g];
              const float b = __fmaf_rn(
                  rc.x, YH, __fmaf_rn(rc.y, YE, __fmaf_rn(c_norm, YY, rc.z)));
              lo[mt][h] =
                  act[mt][h] ? __fsub_ru(__fsub_rd(eps2, b), rc.w) : inf;
              hi[mt][h] =
                  act[mt][h] ? __fsub_rd(__fadd_ru(eps2, b), rc.w) : -inf;
            }
        }
        unsigned amb[MT];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) amb[mt] = 0u;
#pragma unroll
        for (int j = 0; j < B1_CH / 8; ++j) {
          // (No skip of an n-tile without a valid column: a branch per
          // n-tile kept the compiler from overlapping one n-tile's mma
          // with the previous one's epilogue, and cost more than the
          // invalid columns' work.)
          const unsigned vb = ((j < 4 ? v0 : v1) >> (8 * (j & 3))) & 0xffu;
          const int cb = ch * B1_CH + j * 8;
          unsigned bf[KS][2];
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            const __nv_bfloat16* bp = yb + (size_t)(cb + g) * YS + kk * 16 +
                                      2 * t4;
            bf[kk][0] = *reinterpret_cast<const unsigned*>(bp);
            bf[kk][1] = *reinterpret_cast<const unsigned*>(bp + 8);
          }
          const float y0 = yyv[cb + 2 * t4];
          const float y1 = yyv[cb + 2 * t4 + 1];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kk = 0; kk < KS; ++kk) bt_mma(acc, af[mt][kk], bf[kk]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1;
              // t = fl(|Y|^2 - 2 dot) (2 dot is exact: one rounding); the
              // pair's d2f is |X|^2 + t, which the row's bounds absorb.
              const float t = __fmaf_rn(-2.f, acc[e], (e & 1) ? y1 : y0);
              if (MODE == B1_DEFAULT) {
                b1_count_le(t, thd[mt][h], cnt[mt][h]);
              } else {
                b1_cert(t, lo[mt][h], hi[mt][h], 1u << (4 * j + e),
                        cnt[mt][h], amb[mt]);
                if (MODE == B1_MIXED)
                  b1_count_in(t, slo[mt][h], shi[mt][h], n_band);
              }
            }
          }
          if (MODE != B1_DEFAULT) {
            // Only valid columns are queued (e = 0, 2 hold column 2 t4,
            // e = 1, 3 column 2 t4 + 1).
            const unsigned cm = ((vb >> (2 * t4)) & 3u) * 5u;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
              amb[mt] &= ~((~cm & 0xfu) << (4 * j));
          }
        }
        if (MODE == B1_DEFAULT) continue;
        // The exact fallback: the warp's undecided pairs of this chunk,
        // each lane taking two and deciding them with the axis-ordered _rn
        // d^2 of the plain version.  Pair k of the warp's list (lanes in
        // order, each lane's bits in (mt, bit) order) is found from the
        // inclusive counts by a binary search over the lanes and a select
        // in the owner's words, all by shuffles, so no list is written.
        // The row and the column come from the block's FP32 copies in
        // shared memory, both zero-padded to K axes (a zero axis adds +0),
        // as float4s with 16 axes' loads issued before their arithmetic:
        // the sum is a serial chain, and the fallback is latency-bound.
        int nq = 0;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) nq += __popc(amb[mt]);
        if (!__any_sync(0xffffffffu, nq != 0)) continue;
        int incl = nq;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, o);
          if (lane >= o) incl += t;
        }
        const int excl = incl - nq;
        const int tot = __shfl_sync(0xffffffffu, incl, 31);
        n_resc += nq;
        // Two pairs per lane and round (k0 + lane, k0 + 32 + lane), each
        // step written for both, so that their latencies overlap.
        for (int k0 = 0; k0 < tot; k0 += 64) {  // uniform
          int lr[2], cl[2];
          bool ok[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int k = k0 + 32 * u + lane;
            int src = 0;  // the first lane whose inclusive count exceeds k
#pragma unroll
            for (int st = 16; st > 0; st >>= 1)
              if (__shfl_sync(0xffffffffu, incl, src + st - 1) <= k)
                src += st;
            // Its word holding the pair, and the pair's rank within it.
            const int rk = k - __shfl_sync(0xffffffffu, excl, src);
            int sel = 0, off = 0, base = 0;
            unsigned word = 0u;
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              const unsigned w = __shfl_sync(0xffffffffu, amb[mt], src);
              const int c = __popc(w);
              if (rk >= base && rk < base + c) {
                sel = mt;
                word = w;
                off = rk - base;
              }
              base += c;
            }
            const int bit = (int)__fns(word, 0u, off + 1) & 31;  // 4 j + e
            lr[u] = wrow + sel * 16 + (src >> 2) + ((bit >> 1) & 1) * 8;
            cl[u] = ch * B1_CH + (bit >> 2) * 8 + 2 * (src & 3) + (bit & 1);
            // Past the list, or a row past the tile (only a NaN d2f
            // reaches the fallback there): nothing to decide.
            ok[u] = k < tot && rbase + lr[u] < tile;
          }
          float d2[2] = {0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < KS; ++kk) {
            float4 xa[2][4], ya[2][4];
#pragma unroll
            for (int u = 0; u < 2; ++u)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                xa[u][q] = reinterpret_cast<const float4*>(
                    xs + lr[u] * K)[kk * 4 + q];
                ya[u][q] = reinterpret_cast<const float4*>(
                    ys + cl[u] * KP)[kk * 4 + q];
              }
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                float df = __fsub_rn(xa[u][q].x, ya[u][q].x);
                d2[u] = __fadd_rn(d2[u], __fmul_rn(df, df));
                df = __fsub_rn(xa[u][q].y, ya[u][q].y);
                d2[u] = __fadd_rn(d2[u], __fmul_rn(df, df));
                df = __fsub_rn(xa[u][q].z, ya[u][q].z);
                d2[u] = __fadd_rn(d2[u], __fmul_rn(df, df));
                df = __fsub_rn(xa[u][q].w, ya[u][q].w);
                d2[u] = __fadd_rn(d2[u], __fmul_rn(df, df));
              }
          }
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (ok[u] && d2[u] <= eps2) atomicAdd(racc + lr[u], 1);
        }
      }
    }
    if (MODE == B1_MIXED && flags &&
        __any_sync(0xffffffffu, n_band != band0) && lane == 0) {
      PPT_CHECK(p, row_ptr[gridDim.x]);
      flags[p] = 1;
    }
  }

  // Each row's count is spread over the four lanes of its quad: fold it,
  // then add the row's exact verdicts (queued by this warp only).
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int v = cnt[mt][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      cnt[mt][h] = v;
    }
  __syncwarp();
  if (t4 == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int li = wrow + mt * 16 + h * 8 + g;
        if (act[mt][h]) {
          PPT_CHECK(row0 + rbase + li, n);
          out[row0 + rbase + li] = cnt[mt][h] + racc[li];
        }
      }
  }
  if (MODE != B1_DEFAULT && rescored) {
    unsigned long long v = n_resc;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0 && v) atomicAdd(rescored, v);
  }
  if (MODE == B1_MIXED && band_pairs) {
    unsigned long long v = n_band;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0 && v) atomicAdd(band_pairs, v);
  }
}

// v rounded up to FP32.
static float b1_round_up(double v) {
  float f = (float)v;
  if ((double)f < v) f = nextafterf(f, INFINITY);
  return f;
}

template <int MODE, int KS>
static int b1_launch_ks(const float* pts, const int* mask, const int* row_ptr,
                        const int* cols, const float* centers,
                        const float* rnorm, float eps2, long long n, int d,
                        int tile, int nt, int* out,
                        unsigned long long* band_pairs, int* flags,
                        unsigned long long* rescored, cudaStream_t s) {
  constexpr int MT = b1_mt(KS);
  // As many warps as the tile has 16 MT-row groups, at most B1_WARPS.
  const int nw = min(B1_WARPS, (tile + 16 * MT - 1) / (16 * MT));
  const int rb = nw * 16 * MT;
  const int cw = min(b1_slab_cap(KS), (tile + B1_CH - 1) / B1_CH * B1_CH);
  const size_t smem = b1_smem(KS, rb, cw, MODE != B1_DEFAULT).total;
  // The certified band's coefficients (sketch_kernels.cu's header, K =
  // 16 KS); ops/distances.certified_band_coefs is the same expression.
  const double K = 16.0 * KS;
  const double hd = 1.0 - (2.0 * d + 8.0 * K + 64.0) * ldexp(1.0, -24);
  const double h = hd > 0.0 ? 1.0 / hd : INFINITY;
  const float c_cross = b1_round_up(2.5 * h);
  const float c_acc = b1_round_up(1.25 * ldexp(1.0, -20) * K * h);
  const float c_norm =
      b1_round_up(1.25 * (3.0 * d + 12.0) * ldexp(1.0, -24) * h);
  cudaError_t err = cudaFuncSetAttribute(
      b1_tc_kernel<MODE, KS, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nt, (tile + rb - 1) / rb);
  b1_tc_kernel<MODE, KS, MT><<<grid, nw * 32, smem, s>>>(
      pts, mask, row_ptr, cols, centers, rnorm, eps2, n, d, tile, cw, c_cross,
      c_acc, c_norm, out, band_pairs, flags, rescored);
  return (int)cudaGetLastError();
}

template <int MODE>
static int b1_launch(const float* pts, const int* mask, const int* row_ptr,
                     const int* cols, const float* centers,
                     const float* rnorm, float eps2, long long n, int d,
                     int tile, int nt, int* out,
                     unsigned long long* band_pairs, int* flags,
                     unsigned long long* rescored, cudaStream_t s) {
#define PP_B1_KS(KS)                                                       \
  b1_launch_ks<MODE, KS>(pts, mask, row_ptr, cols, centers, rnorm, eps2, n, \
                         d, tile, nt, out, band_pairs, flags, rescored, s)
  if (d <= 16) return PP_B1_KS(1);
  if (d <= 32) return PP_B1_KS(2);
  if (d <= 48) return PP_B1_KS(3);
  return PP_B1_KS(4);
#undef PP_B1_KS
}

extern "C" {

// B1: per-point neighbour counts, every precision mode.  pts (d, n)
// float32; mask (n,) int32; row_ptr (nt + 1,) int32; cols int32; centers
// (nt, d) float32, the row tiles' recentring points (any points; the
// wrapper gives the box centres over the mask), needed at d <= 64 and by
// the bf16 modes; rnorm (nt, 2) float32 ([nx, gx] norm maxima over the
// mask, "mixed" only); mode 0 ("high", "highest"), 1 ("mixed") or 2
// ("default"); out (n,) int32; band_pairs one uint64 counter and flags one
// int32 per pair-list entry ("mixed": the reference band's stats) and
// rescored_pairs one uint64 counter (d <= 64, modes 0 and 1: the pairs the
// exact fallback decided), all zeroed by the caller (any may be NULL).
// Returns the cudaError_t of the launch.
int pp_count_pairs(const float* pts, const int* mask, const int* row_ptr,
                   const int* cols, const float* centers, const float* rnorm,
                   float eps2, long long n, int d, int tile, int nt, int mode,
                   int* out, unsigned long long* band_pairs, int* flags,
                   unsigned long long* rescored_pairs, void* stream) {
  if (nt <= 0 || tile <= 0) return 0;
  if (mode < B1_EXACT || mode > B1_DEFAULT) return (int)cudaErrorInvalidValue;
  if (mode == B1_MIXED && !rnorm) return (int)cudaErrorInvalidValue;
  if (mode != B1_EXACT && !centers) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d > 64) {
    if (mode == B1_EXACT)
      return slice_launch<0>(pts, mask, row_ptr, cols, eps2, n, d, tile, nt,
                             nullptr, nullptr, out, nullptr, s);
    if (mode == B1_DEFAULT)
      return fast_launch<0, 1>(pts, mask, row_ptr, cols, centers, rnorm,
                               eps2, n, d, tile, nt, out, nullptr, nullptr,
                               nullptr, nullptr, nullptr, stream);
    return fast_launch<0, 0>(pts, mask, row_ptr, cols, centers, rnorm, eps2,
                             n, d, tile, nt, out, band_pairs, flags, nullptr,
                             nullptr, nullptr, stream);
  }
  if (!centers) return (int)cudaErrorInvalidValue;
  if (mode == B1_EXACT)
    return b1_launch<B1_EXACT>(pts, mask, row_ptr, cols, centers, nullptr,
                               eps2, n, d, tile, nt, out, nullptr, nullptr,
                               rescored_pairs, s);
  if (mode == B1_MIXED)
    return b1_launch<B1_MIXED>(pts, mask, row_ptr, cols, centers, rnorm,
                               eps2, n, d, tile, nt, out, band_pairs, flags,
                               rescored_pairs, s);
  return b1_launch<B1_DEFAULT>(pts, mask, row_ptr, cols, centers, nullptr,
                               eps2, n, d, tile, nt, out, nullptr, nullptr,
                               nullptr, s);
}

// B2: per-point minimum source label within eps (labels INT32_MAX for
// non-source points).  pts, row_ptr, cols as pp_count_pairs, plus
// tile_min (nt,) int32 (each tile's least label), live_rows NULL or (n,)
// bytes (the rows in the skip's bound; the rest get INT32_MAX) and
// evaluated NULL or one uint64 counter to which the launch adds the
// (block, chunk) pairs it evaluated.
int pp_minlab_pairs(const float* pts, const int* labels, const int* row_ptr,
                    const int* cols, float eps2, long long n, int d,
                    int tile, int nt, const int* tile_min,
                    const unsigned char* live_rows, int* out,
                    unsigned long long* evaluated, void* stream) {
  return minlab_launch(pts, labels, row_ptr, cols, eps2, n, d, tile, nt,
                       tile_min, live_rows, out, evaluated, stream);
}

// B2 under "mixed" (fast = 0) or "default" (fast = 1): as pp_minlab_pairs
// with centers (nt, d) float32 (the row tiles' box centres over the row
// mask) and, under "mixed", rnorm (nt, 2) float32 (their [nx, gx] norm
// maxima over it).
int pp_minlab_pairs_fast(const float* pts, const int* labels,
                         const int* row_ptr, const int* cols,
                         const float* centers, const float* rnorm, float eps2,
                         long long n, int d, int tile, int nt, int fast,
                         const int* tile_min,
                         const unsigned char* live_rows, int* out,
                         unsigned long long* evaluated, void* stream) {
  if (fast)
    return fast_launch<1, 1>(pts, labels, row_ptr, cols, centers, rnorm, eps2,
                             n, d, tile, nt, out, nullptr, nullptr, tile_min,
                             live_rows, evaluated, stream);
  return fast_launch<1, 0>(pts, labels, row_ptr, cols, centers, rnorm, eps2,
                           n, d, tile, nt, out, nullptr, nullptr, tile_min,
                           live_rows, evaluated, stream);
}

}  // extern "C"
