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
//      fits), and a warp computes the exact d2 only for the groups of 8
//      columns its own rows need.  So the rescore
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
// pairs 3d more; the bytes (coordinates, slab and CSR once) are far below,
// so the kernels are bound by FP32 SIMT throughput.  The arithmetic is unfused
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
// of the 32 labels each warp reads from global memory itself (so no
// barrier is spent on a skipped chunk), is >= the bound.  The bound is a
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
// Precision modes.  "mixed" is this kernel as it stands (the TPU kernels
// rescore at "high" there); the band comes from sketch_gate_band in that
// mode.  "default" (FAST = 1, with the row tiles' box centres) decides
// the in-band pairs with the bf16 tile routine of bf16_tile.cuh instead
// of the exact d2, as the TPU kernel's single bf16 dot does: a warp that
// needs a rescore runs mma.sync over its 32 rows x the 8-column groups it
// needs, K = d padded to 16, the rows recentred on the row tile's centre
// and read from global memory, the columns converted from the same staged
// FP32 slices the exact rescore reads; the squared norms are FP32 sums,
// and each row's verdict bits are folded across the quad that holds them
// and handed to the lane that owns the row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"

#define SK_INT_INF 2147483647
#define SK_INT_MIN (-SK_INT_INF - 1)
#define SK_THREADS 256
#define SK_WARPS (SK_THREADS / 32)
#define SK_CH 32    // columns per chunk: one bit each in a 32-bit mask
#define SK_AX 8     // axes per register step
#define SK_AXMAX 512  // full-d axes staged per slice

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

// Asynchronous 4-byte global -> shared copy; bytes past src_size (0 or 4)
// are zero-filled.
__device__ __forceinline__ void sk_cp4(void* dst, const void* src,
                                      int src_size) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_size));
}
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
    sk_cp4(ys + e, in ? pts + a * n + col0 + t : pts, in ? 4 : 0);
  }
}

// B4's chunk search: from chunk (p, j0) on, the first chunk whose minimum
// label L is below the bound, passing over whole entries whose column
// tile's minimum is not.  Every warp reads the same labels, so the result
// is uniform over the block without a barrier.  Returns false (p == p1)
// when none is left.
__device__ __forceinline__ bool sk_find(
    const int* __restrict__ colval, const int* __restrict__ cols,
    const int* __restrict__ tile_min, int tile, int p1, int bnd, int& p,
    int& j0, int& L) {
  const int lane = threadIdx.x & 31;
  for (; p < p1; ++p, j0 = 0) {
    const int ct = __ldg(cols + p);
    if (__ldg(tile_min + ct) >= bnd) continue;
    const long long c0 = (long long)ct * tile;
    for (; j0 < tile; j0 += SK_CH) {
      const int v = lane < min(SK_CH, tile - j0)
                        ? __ldg(colval + c0 + j0 + lane)
                        : SK_INT_INF;
      L = __reduce_min_sync(0xffffffffu, v);
      if (L < bnd) return true;
    }
  }
  return false;
}

template <int MODE, int FAST>
__global__ void __launch_bounds__(SK_THREADS) sketch_pair_kernel(
    const float* __restrict__ pts, const float* __restrict__ slab,
    const int* __restrict__ colval, const int* __restrict__ row_ptr,
    const int* __restrict__ cols, const float* __restrict__ centers,
    float eps2, float band, long long n, int d, int dp, int ax, int skp,
    int k, int tile, int* __restrict__ out,
    unsigned long long* __restrict__ band_pairs, int* __restrict__ flags,
    const int* __restrict__ tile_min,
    unsigned long long* __restrict__ evaluated) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);           // ax x SK_CH
  float* ss = ys + (size_t)ax * SK_CH;                    // skp x SK_CH
  int* sv = reinterpret_cast<int*>(ss + (size_t)skp * SK_CH);  // SK_CH
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
  // "default": the row tile's centre and this row's |x - c|^2.
  const float* ctr = FAST ? centers + (long long)r * d : nullptr;
  float xxr = 0.f;
  if (FAST) {
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
      if (!sk_find(colval, cols, tile_min, tile, p1, bnd, p, j0, L)) break;
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
          sk_cp4(sv + threadIdx.x, colval + col0 + threadIdx.x, 4);
        else
          sv[threadIdx.x] = inval;
      }
      for (int e = threadIdx.x; e < skp * SK_CH; e += blockDim.x) {
        const int a = e / SK_CH;
        const int t = e % SK_CH;
        sk_cp4(ss + e, t < w ? slab + a * n + col0 + t : slab, t < w ? 4 : 0);
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
        for (int s0 = 0; s0 < dp; s0 += ax) {
          const int as = min(ax, dp - s0);
          if (s0 > 0) {
            __syncthreads();  // the previous slice is consumed
            sk_stage_full(ys, pts, n, d, s0, as, col0, w);
            sk_commit();
          }
          sk_wait<0>();
          __syncthreads();
          if (FAST && warp_m) {
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
        if (FAST) {
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
          const int src = (lane & 7) * 4;
          const unsigned v00 = __shfl_sync(0xffffffffu, rm[0][0], src);
          const unsigned v01 = __shfl_sync(0xffffffffu, rm[0][1], src);
          const unsigned v10 = __shfl_sync(0xffffffffu, rm[1][0], src);
          const unsigned v11 = __shfl_sync(0xffffffffu, rm[1][1], src);
          const int sel = lane >> 3;
          const unsigned fb = sel == 0 ? v00 : sel == 1 ? v01
                              : sel == 2 ? v10 : v11;
          in_m |= band_m & fb;
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
  if (active) out[row] = res;
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

template <int MODE, int FAST>
static int launch_mode(const float* pts, const float* slab, const int* colval,
                       const int* row_ptr, const int* cols,
                       const float* centers, float eps2, float band,
                       long long n, int d, int skp, int k, int tile, int nt,
                       int* out, unsigned long long* band_pairs, int* flags,
                       const int* tile_min, unsigned long long* evaluated,
                       void* stream) {
  // FAST stages whole k-steps of 16 axes.
  const int al = FAST ? 16 : SK_AX;
  const int dp = (d + al - 1) / al * al;
  const int ax = dp < SK_AXMAX ? dp : SK_AXMAX;
  const size_t smem = ((size_t)ax * SK_CH + (size_t)skp * SK_CH) * 4 +
                      (size_t)SK_CH * 4;
  cudaError_t err = cudaFuncSetAttribute(
      sketch_pair_kernel<MODE, FAST>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(nt, (tile + SK_THREADS - 1) / SK_THREADS);
  sketch_pair_kernel<MODE, FAST><<<grid, SK_THREADS, smem,
                                   reinterpret_cast<cudaStream_t>(stream)>>>(
      pts, slab, colval, row_ptr, cols, centers, eps2, band, n, d, dp, ax,
      skp, k, tile, out, band_pairs, flags, tile_min, evaluated);
  return (int)cudaGetLastError();
}

template <int MODE>
static int launch(const float* pts, const float* slab, const int* colval,
                  const int* row_ptr, const int* cols, const float* centers,
                  float eps2, float band, long long n, int d, int skp, int k,
                  int tile, int nt, int* out, unsigned long long* band_pairs,
                  int* flags, const int* tile_min,
                  unsigned long long* evaluated, void* stream) {
  if (nt <= 0 || tile <= 0) return 0;
  if (skp % SK_AX != 0 || k < 0 || k >= skp)
    return (int)cudaErrorInvalidValue;
  if (MODE == 1 && !tile_min) return (int)cudaErrorInvalidValue;
  if (centers)
    return launch_mode<MODE, 1>(pts, slab, colval, row_ptr, cols, centers,
                                eps2, band, n, d, skp, k, tile, nt, out,
                                band_pairs, flags, tile_min, evaluated,
                                stream);
  return launch_mode<MODE, 0>(pts, slab, colval, row_ptr, cols, nullptr,
                              eps2, band, n, d, skp, k, tile, nt, out,
                              band_pairs, flags, tile_min, evaluated, stream);
}

extern "C" {

// B3: per-point neighbour counts through the sketch gate.  pts (d, n) and
// slab (skp, n) float32; mask (n,) int32; row_ptr (nt + 1,) int32; cols
// int32; centers NULL (the exact rescore: "high", "highest", "mixed") or
// (nt, d) float32, the row tiles' box centres over the mask (the bf16
// rescore of "default"); out (n,) int32; band_pairs one uint64 counter and
// flags one int32 per pair-list entry, both zeroed by the caller (either
// may be NULL).  Returns the cudaError_t of the launch.
int pp_count_pairs_sketch(const float* pts, const float* slab,
                          const int* mask, const int* row_ptr,
                          const int* cols, const float* centers, float eps2,
                          float band, long long n, int d, int skp, int k,
                          int tile, int nt, int* out,
                          unsigned long long* band_pairs, int* flags,
                          void* stream) {
  return launch<0>(pts, slab, mask, row_ptr, cols, centers, eps2, band, n, d,
                   skp, k, tile, nt, out, band_pairs, flags, nullptr, nullptr,
                   stream);
}

// B4: per-point minimum source label within eps through the sketch gate
// (labels INT32_MAX for non-source points).  Same layout as B3 (centers
// over the row mask), plus tile_min (nt,) int32, the minimum label of
// each tile, and evaluated, NULL or one uint64 counter, zeroed by the
// caller, to which the kernel adds the (block, chunk) pairs it evaluated.
int pp_minlab_pairs_sketch(const float* pts, const float* slab,
                           const int* labels, const int* row_ptr,
                           const int* cols, const float* centers,
                           float eps2, float band, long long n, int d,
                           int skp, int k, int tile, int nt, int* out,
                           const int* tile_min,
                           unsigned long long* evaluated, void* stream) {
  return launch<1>(pts, slab, labels, row_ptr, cols, centers, eps2, band, n,
                   d, skp, k, tile, nt, out, nullptr, nullptr, tile_min,
                   evaluated, stream);
}

}  // extern "C"
