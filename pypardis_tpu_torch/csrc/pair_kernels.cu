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
//
// Design.  The TPU grid ran the pair list in order and carried each
// row's accumulator from one grid step to the next; Hopper's blocks run
// in no order, so here one block owns a slice of one row tile and loops
// over that tile's live column tiles itself: each thread owns one output
// row, keeps its coordinates in registers (d <= 64; past that the
// axis-sliced path below), stages each column chunk (coordinates plus
// mask or labels) in shared memory, keeps its count or minimum in a
// register and writes its row once.  No atomics, no inter-block
// reduction, deterministic.  Rows whose tile has no live pair get the
// identity (0 or INT32_MAX).
//
// d^2 is (x_a - y_a)^2 summed over the axes in index order with
// __fsub_rn/__fmul_rn/__fadd_rn, so no multiply-add is contracted: the
// plain PyTorch version (ops/distances._pair_d2) repeats the same
// operations and is bitwise equal to this kernel on any data.  No
// recentring is needed, since the difference form has no |x|^2+|y|^2-2xy
// cancellation.
//
// Bound.  Per pair of points the kernel spends 3d FP32 SIMT operations
// and a compare; the bytes it must move are the coordinates once, so at
// the fit's tile sizes it is bound by FP32 SIMT issue, not by memory.
// The arithmetic is unfused, one FP32 instruction per operation, so the
// SIMT ceiling is half the card's FFMA-counted 67 TFLOP/s.  B2 skips
// most pairs (below): its floor is the pairs a label-exact method must
// still rule out.
// What the design does about it: coordinates of the row live in
// registers, the staged column point is read as float4 broadcasts from
// shared memory (one load per four axes, no bank conflicts since every
// thread of the block reads the same address), and a column whose mask
// is 0 (B1) or whose label is INT32_MAX (B2) is skipped before any
// arithmetic - a branch that is uniform across the block.
//
// Precision modes (fast_pair_kernel below).  Under "mixed" and "default"
// the TPU kernels run _mixed_classify / a single bf16 dot; here:
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
//     queued pairs one each and decide them with B1's exact arithmetic
//     above (the rows and columns staged in FP32 for d <= 64, read from
//     global memory beyond), adding to a per-row count (or minimum) in
//     shared memory.  So the rescore runs per pair, not per tile: on
//     clustered data nearly every tile holds an in-band pair, and a
//     whole-tile rescore would cost what "high" costs.
// The band is sound for every valid row (band_halfwidth bounds the bf16
// error of the cross term, exact_slack the FP32 rounding of the exact
// pass), so counts and labels equal the FP32 kernel's on valid rows.  B1
// also counts the in-band pairs of valid rows and columns (one 64-bit
// counter) and flags each pair-list entry holding one.  Rows outside the
// row mask the frames were taken over carry no guarantee (the callers
// mask them, as on the TPU).
//
// Bound of the fast pass: 2 K tensor-core operations per pair (K = d
// padded to 16) and about ten FP32 epilogue operations; at d = 16 the
// epilogue, not the mma, is the larger, so the pass is bound by FP32 issue
// in the epilogue and by the per-pair exact rescore of the in-band pairs.
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
#include <stdint.h>

#include "bf16_tile.cuh"
#include "label_bound.cuh"

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

// B1 at d <= 64 (DC = d rounded up to 4, 8, 16, 32 or 64): counts of
// valid columns within eps.
template <int DC>
__global__ void __launch_bounds__(PP_THREADS) pair_kernel(
    const float* __restrict__ pts, const int* __restrict__ colval,
    const int* __restrict__ row_ptr, const int* __restrict__ cols,
    float eps2, long long n, int d, int tile, int ch,
    int* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const int dp = (d + 3) & ~3;
  float* ys = reinterpret_cast<float*>(smem4);
  int* sv = reinterpret_cast<int*>(ys + (size_t)ch * dp);

  const int r = blockIdx.x;
  const int local = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = local < tile;
  const long long row = (long long)r * tile + (active ? local : 0);

  float xr[DC];
#pragma unroll
  for (int a = 0; a < DC; ++a) xr[a] = a < d ? pts[a * n + row] : 0.f;

  int acc = 0;
  const int p0 = row_ptr[r];
  const int p1 = row_ptr[r + 1];
  for (int p = p0; p < p1; ++p) {
    const long long c0 = (long long)cols[p] * tile;
    for (int j0 = 0; j0 < tile; j0 += ch) {
      const int w = min(ch, tile - j0);
      __syncthreads();  // the previous chunk is consumed
      for (int t = threadIdx.x; t < w; t += blockDim.x)
        sv[t] = colval[c0 + j0 + t];
      // Padded axes (d <= a < dp) hold 0 on both sides: each adds +0,
      // which leaves d2 unchanged exactly.
      for (int e = threadIdx.x; e < dp * w; e += blockDim.x) {
        const int a = e / w;
        const int t = e - a * w;
        ys[t * dp + a] = a < d ? pts[a * n + c0 + j0 + t] : 0.f;
      }
      __syncthreads();
      if (!active) continue;
      for (int t = 0; t < w; ++t) {
        if (sv[t] == 0) continue;
        if (pp_d2_regs<DC>(xr, ys + t * dp, d) <= eps2) ++acc;
      }
    }
  }
  if (active) out[row] = acc;
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
  if (active) out[row] = inb ? m : PP_INT_INF;
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
static int count_launch_dc(dim3 grid, size_t smem, cudaStream_t stream,
                           const float* pts, const int* colval,
                           const int* row_ptr, const int* cols, float eps2,
                           long long n, int d, int tile, int ch, int* out) {
  pair_kernel<DC><<<grid, PP_THREADS, smem, stream>>>(
      pts, colval, row_ptr, cols, eps2, n, d, tile, ch, out);
  return (int)cudaGetLastError();
}

static int count_launch(const float* pts, const int* colval,
                        const int* row_ptr, const int* cols, float eps2,
                        long long n, int d, int tile, int nt, int* out,
                        void* stream) {
  if (nt <= 0 || tile <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d > 64)
    return slice_launch<0>(pts, colval, row_ptr, cols, eps2, n, d, tile, nt,
                           nullptr, nullptr, out, nullptr, s);
  const int dp = (d + 3) & ~3;
  // Column chunk: as many staged points as fit in 48 KB of shared
  // memory (the default limit), capped at 256.
  const int ch = min(PP_MAX_CHUNK, PP_SMEM_BYTES / (4 * (dp + 1)));
  const size_t smem = (size_t)ch * dp * 4 + (size_t)ch * 4;
  const dim3 grid(nt, (tile + PP_THREADS - 1) / PP_THREADS);
  if (d <= 4)
    return count_launch_dc<4>(grid, smem, s, pts, colval, row_ptr, cols,
                              eps2, n, d, tile, ch, out);
  if (d <= 8)
    return count_launch_dc<8>(grid, smem, s, pts, colval, row_ptr, cols,
                              eps2, n, d, tile, ch, out);
  if (d <= 16)
    return count_launch_dc<16>(grid, smem, s, pts, colval, row_ptr, cols,
                               eps2, n, d, tile, ch, out);
  if (d <= 32)
    return count_launch_dc<32>(grid, smem, s, pts, colval, row_ptr, cols,
                               eps2, n, d, tile, ch, out);
  return count_launch_dc<64>(grid, smem, s, pts, colval, row_ptr, cols,
                             eps2, n, d, tile, ch, out);
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
  if (d <= 16) return PP_FAST_KS(1);
  if (d <= 32) return PP_FAST_KS(2);
  if (d <= 48) return PP_FAST_KS(3);
  if (d <= 64) return PP_FAST_KS(4);
  return PP_FAST_KS(0);
#undef PP_FAST_KS
}

extern "C" {

// B1: per-point neighbour counts.  pts (d, n) float32; mask (n,) int32;
// row_ptr (nt + 1,) int32; cols int32; out (n,) int32.  Returns the
// cudaError_t of the launch.
int pp_count_pairs(const float* pts, const int* mask, const int* row_ptr,
                   const int* cols, float eps2, long long n, int d,
                   int tile, int nt, int* out, void* stream) {
  return count_launch(pts, mask, row_ptr, cols, eps2, n, d, tile, nt, out,
                      stream);
}

// B2: per-point minimum source label within eps (labels INT32_MAX for
// non-source points).  Layout as pp_count_pairs, plus tile_min (nt,)
// int32 (each tile's least label), live_rows NULL or (n,) bytes (the rows
// in the skip's bound; the rest get INT32_MAX) and evaluated NULL or one
// uint64 counter to which the launch adds the (block, chunk) pairs it
// evaluated.
int pp_minlab_pairs(const float* pts, const int* labels, const int* row_ptr,
                    const int* cols, float eps2, long long n, int d,
                    int tile, int nt, const int* tile_min,
                    const unsigned char* live_rows, int* out,
                    unsigned long long* evaluated, void* stream) {
  return minlab_launch(pts, labels, row_ptr, cols, eps2, n, d, tile, nt,
                       tile_min, live_rows, out, evaluated, stream);
}

// B1 under "mixed" (fast = 0) or "default" (fast = 1).  As
// pp_count_pairs, plus centers (nt, d) float32 (the row tiles' box centres
// over the mask) and, under "mixed", rnorm (nt, 2) float32 (their [nx, gx]
// norm maxima over the mask), band_pairs one uint64 counter and flags one
// int32 per pair-list entry, zeroed by the caller (either may be NULL).
int pp_count_pairs_fast(const float* pts, const int* mask, const int* row_ptr,
                        const int* cols, const float* centers,
                        const float* rnorm, float eps2, long long n, int d,
                        int tile, int nt, int fast, int* out,
                        unsigned long long* band_pairs, int* flags,
                        void* stream) {
  if (fast)
    return fast_launch<0, 1>(pts, mask, row_ptr, cols, centers, rnorm, eps2,
                             n, d, tile, nt, out, nullptr, nullptr, nullptr,
                             nullptr, nullptr, stream);
  return fast_launch<0, 0>(pts, mask, row_ptr, cols, centers, rnorm, eps2, n,
                           d, tile, nt, out, band_pairs, flags, nullptr,
                           nullptr, nullptr, stream);
}

// B2 under "mixed" or "default": as pp_count_pairs_fast with labels
// (INT32_MAX for non-source points) and the frames over the row mask, no
// stats, and B2's skip arguments of pp_minlab_pairs.
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
