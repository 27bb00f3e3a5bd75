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
// row, keeps its coordinates in registers (DC > 0; DC = 0 re-reads them
// from global memory at large d), stages each column chunk (coordinates
// plus mask or labels) in shared memory, keeps its count or minimum in a
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

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"

#define PP_INT_INF 2147483647
#define PP_THREADS 256
#define PP_MAX_CHUNK 256
#define PP_SMEM_BYTES 49152

template <int MODE, int DC>
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

  float xr[DC > 0 ? DC : 1];
  if (DC > 0) {
#pragma unroll
    for (int a = 0; a < DC; ++a) xr[a] = a < d ? pts[a * n + row] : 0.f;
  }

  int acc = MODE == 0 ? 0 : PP_INT_INF;
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
        const int v = sv[t];
        if (MODE == 0 ? v == 0 : v == PP_INT_INF) continue;
        const float* y = ys + t * dp;
        float d2 = 0.f;
        if (DC > 0) {
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
        } else {
          for (int a = 0; a < d; ++a) {
            const float df = __fsub_rn(__ldg(pts + a * n + row), y[a]);
            d2 = __fadd_rn(d2, __fmul_rn(df, df));
          }
        }
        if (d2 <= eps2) acc = MODE == 0 ? acc + 1 : min(acc, v);
      }
    }
  }
  if (active) out[row] = acc;
}

template <int MODE, int DC>
static void launch_dc(dim3 grid, size_t smem, cudaStream_t stream,
                      const float* pts, const int* colval,
                      const int* row_ptr, const int* cols, float eps2,
                      long long n, int d, int tile, int ch, int* out) {
  // One staged column past 12,287 axes needs more than the default
  // 48 KB; the launch then reports the opt-in's error, if any.
  if (smem > PP_SMEM_BYTES &&
      cudaFuncSetAttribute(pair_kernel<MODE, DC>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return;
  pair_kernel<MODE, DC><<<grid, PP_THREADS, smem, stream>>>(
      pts, colval, row_ptr, cols, eps2, n, d, tile, ch, out);
}

template <int MODE>
static int launch(const float* pts, const int* colval, const int* row_ptr,
                  const int* cols, float eps2, long long n, int d, int tile,
                  int nt, int* out, void* stream) {
  if (nt <= 0 || tile <= 0) return 0;
  const int dp = (d + 3) & ~3;
  // Column chunk: as many staged points as fit in 48 KB of shared
  // memory (the default limit), capped at 256.
  int ch = PP_SMEM_BYTES / (4 * (dp + 1));
  if (ch > PP_MAX_CHUNK) ch = PP_MAX_CHUNK;
  if (ch < 1) ch = 1;
  const size_t smem = (size_t)ch * dp * 4 + (size_t)ch * 4;
  const dim3 grid(nt, (tile + PP_THREADS - 1) / PP_THREADS);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d <= 4)
    launch_dc<MODE, 4>(grid, smem, s, pts, colval, row_ptr, cols, eps2, n,
                       d, tile, ch, out);
  else if (d <= 8)
    launch_dc<MODE, 8>(grid, smem, s, pts, colval, row_ptr, cols, eps2, n,
                       d, tile, ch, out);
  else if (d <= 16)
    launch_dc<MODE, 16>(grid, smem, s, pts, colval, row_ptr, cols, eps2, n,
                        d, tile, ch, out);
  else if (d <= 32)
    launch_dc<MODE, 32>(grid, smem, s, pts, colval, row_ptr, cols, eps2, n,
                        d, tile, ch, out);
  else if (d <= 64)
    launch_dc<MODE, 64>(grid, smem, s, pts, colval, row_ptr, cols, eps2, n,
                        d, tile, ch, out);
  else
    launch_dc<MODE, 0>(grid, smem, s, pts, colval, row_ptr, cols, eps2, n,
                       d, tile, ch, out);
  return (int)cudaGetLastError();
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
  s.red = o; o += 2 * FP_WARPS * 4;
  s.q = o;   if (!fast) o += (size_t)FP_WARPS * FP_QCAP * 2;
  s.total = o;
  return s;
}

// MODE 0 counts (B1), 1 min labels (B2); FAST 0 "mixed", 1 "default";
// KS > 0: d <= 16 KS, A fragments in registers; KS == 0: d > 64, K slices.
template <int MODE, int FAST, int KS>
__global__ void __launch_bounds__(FP_THREADS) fast_pair_kernel(
    const float* __restrict__ pts, const int* __restrict__ colval,
    const int* __restrict__ row_ptr, const int* __restrict__ cols,
    const float* __restrict__ centers, const float* __restrict__ rnorm,
    float eps2, long long n, int d, int tile, int* __restrict__ out,
    unsigned long long* __restrict__ band_pairs, int* __restrict__ flags) {
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

  int acc0 = ident, acc1 = ident;
  unsigned n_band = 0;
  for (int p = p0; p < p1; ++p) {
    const long long c0 = (long long)cols[p] * tile;
    float band = 0.f;
    if (!FAST) {
      // The entry's column norm maxima about this row tile's centre.
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
      __syncthreads();  // the previous entry's maxima are read
      if (lane == 0) {
        red[warp] = m1;
        red[FP_WARPS + warp] = m2;
      }
      __syncthreads();
      m1 = red[0];
      m2 = red[FP_WARPS];
      for (int i = 1; i < FP_WARPS; ++i) {
        m1 = fmaxf(m1, red[i]);
        m2 = fmaxf(m2, red[FP_WARPS + i]);
      }
      band = bt_band(rnorm[2 * r], __fsqrt_rn(m1), rnorm[2 * r + 1],
                     __fsqrt_rn(m2));
    }

    for (int j0 = 0; j0 < tile; j0 += FP_CH) {
      const int w = min(FP_CH, tile - j0);
      const long long col0 = c0 + j0;
      float acc[FP_NT][4];
#pragma unroll
      for (int j = 0; j < FP_NT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      const int dk = KS > 0 ? d : FP_KS;
      for (int s0 = 0; s0 < (KS > 0 ? 1 : d); s0 += FP_KS) {
        const int as = KS > 0 ? d : min(FP_KS, d - s0);
        __syncthreads();  // the previous chunk (or slice) is consumed
        if (s0 == 0 && tid < FP_CH)
          cv[tid] = tid < w ? colval[col0 + tid] : inval;
        const int kp = KS > 0 ? KS * 16 : FP_KS;
        for (int e = tid; e < kp * FP_CH; e += FP_THREADS) {
          const int a = e / FP_CH;
          const int t = e - a * FP_CH;
          const bool in = t < w && a < as;
          const float y = in ? __ldg(pts + (s0 + a) * n + col0 + t) : 0.f;
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
            const unsigned m = __ballot_sync(0xffffffffu, amb);
            if (amb) {
              const int rl = (lo ? lr0 : lr1) - rbase;
              queue[warp * FP_QCAP + qn +
                    __popc(m & ((1u << lane) - 1u))] =
                  (unsigned short)((rl << 6) | cl);
              if (lo ? rv0 : rv1) {
                ++n_band;
                had = true;
              }
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
                                    : __ldg(pts + a * n + col0 + cl);
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
    if (act0) out[row0 + lr0] = MODE == 0 ? acc0 + ra : min(acc0, ra);
    if (act1) out[row0 + lr1] = MODE == 0 ? acc1 + rb : min(acc1, rb);
  }
  if (MODE == 0 && !FAST && band_pairs) {
    unsigned long long v = n_band;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0 && v) atomicAdd(band_pairs, v);
  }
}

template <int MODE, int FAST, int KS>
static int fast_launch_ks(dim3 grid, cudaStream_t s, const float* pts,
                          const int* colval, const int* row_ptr,
                          const int* cols, const float* centers,
                          const float* rnorm, float eps2, long long n, int d,
                          int tile, int* out, unsigned long long* band_pairs,
                          int* flags) {
  const size_t smem = fp_smem(d, KS, FAST).total;
  cudaError_t err = cudaFuncSetAttribute(
      fast_pair_kernel<MODE, FAST, KS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fast_pair_kernel<MODE, FAST, KS><<<grid, FP_THREADS, smem, s>>>(
      pts, colval, row_ptr, cols, centers, rnorm, eps2, n, d, tile, out,
      band_pairs, flags);
  return (int)cudaGetLastError();
}

template <int MODE, int FAST>
static int fast_launch(const float* pts, const int* colval,
                       const int* row_ptr, const int* cols,
                       const float* centers, const float* rnorm, float eps2,
                       long long n, int d, int tile, int nt, int* out,
                       unsigned long long* band_pairs, int* flags,
                       void* stream) {
  if (nt <= 0 || tile <= 0) return 0;
  if (!FAST && !rnorm) return (int)cudaErrorInvalidValue;
  const dim3 grid(nt, (tile + FP_ROWS - 1) / FP_ROWS);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d <= 16)
    return fast_launch_ks<MODE, FAST, 1>(grid, s, pts, colval, row_ptr, cols,
                                         centers, rnorm, eps2, n, d, tile,
                                         out, band_pairs, flags);
  if (d <= 32)
    return fast_launch_ks<MODE, FAST, 2>(grid, s, pts, colval, row_ptr, cols,
                                         centers, rnorm, eps2, n, d, tile,
                                         out, band_pairs, flags);
  if (d <= 48)
    return fast_launch_ks<MODE, FAST, 3>(grid, s, pts, colval, row_ptr, cols,
                                         centers, rnorm, eps2, n, d, tile,
                                         out, band_pairs, flags);
  if (d <= 64)
    return fast_launch_ks<MODE, FAST, 4>(grid, s, pts, colval, row_ptr, cols,
                                         centers, rnorm, eps2, n, d, tile,
                                         out, band_pairs, flags);
  return fast_launch_ks<MODE, FAST, 0>(grid, s, pts, colval, row_ptr, cols,
                                       centers, rnorm, eps2, n, d, tile, out,
                                       band_pairs, flags);
}

extern "C" {

// B1: per-point neighbour counts.  pts (d, n) float32; mask (n,) int32;
// row_ptr (nt + 1,) int32; cols int32; out (n,) int32.  Returns the
// cudaError_t of the launch.
int pp_count_pairs(const float* pts, const int* mask, const int* row_ptr,
                   const int* cols, float eps2, long long n, int d,
                   int tile, int nt, int* out, void* stream) {
  return launch<0>(pts, mask, row_ptr, cols, eps2, n, d, tile, nt, out,
                   stream);
}

// B2: per-point minimum source label within eps (labels INT32_MAX for
// non-source points).  Same layout as pp_count_pairs.
int pp_minlab_pairs(const float* pts, const int* labels, const int* row_ptr,
                    const int* cols, float eps2, long long n, int d,
                    int tile, int nt, int* out, void* stream) {
  return launch<1>(pts, labels, row_ptr, cols, eps2, n, d, tile, nt, out,
                   stream);
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
                             n, d, tile, nt, out, nullptr, nullptr, stream);
  return fast_launch<0, 0>(pts, mask, row_ptr, cols, centers, rnorm, eps2, n,
                           d, tile, nt, out, band_pairs, flags, stream);
}

// B2 under "mixed" or "default": as pp_count_pairs_fast with labels
// (INT32_MAX for non-source points) and the frames over the row mask; no
// stats.
int pp_minlab_pairs_fast(const float* pts, const int* labels,
                         const int* row_ptr, const int* cols,
                         const float* centers, const float* rnorm, float eps2,
                         long long n, int d, int tile, int nt, int fast,
                         int* out, void* stream) {
  if (fast)
    return fast_launch<1, 1>(pts, labels, row_ptr, cols, centers, rnorm, eps2,
                             n, d, tile, nt, out, nullptr, nullptr, stream);
  return fast_launch<1, 0>(pts, labels, row_ptr, cols, centers, rnorm, eps2,
                           n, d, tile, nt, out, nullptr, nullptr, stream);
}

}  // extern "C"
