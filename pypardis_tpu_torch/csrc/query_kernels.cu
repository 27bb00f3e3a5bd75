// Out-of-sample query kernel for Hopper (sm_90a), plain C interface.
//
// B5: replaces the TPU's Pallas kernel _query_leaf_kernel
// (pypardis_tpu/ops/pallas_kernels.py, entry query_min_core_pallas).
// For every row of every query tile i it keeps the lexicographic minimum
// of (d2, label) over all C slots of leaf tile_leaf[i]'s core slab, where
// d2 = sum over axes a, in index order, of (q_a - c_a)^2, and returns the
// packed (2, nqt, qb) int32 result [labels, bits(d2)].  Pad slots hold
// 2e19 coordinates (the square overflows to +inf) and INT32_MAX labels,
// so no mask enters the kernel.
//
// Design.  The TPU grid walked a tile's column blocks in order and
// carried the running minimum across grid steps; Hopper's blocks run in
// no order, and one block per query tile would leave most of the 132 SMs
// idle at a serving batch (256 tiles at the 1M index).  So the grid is
// (tile, split, row group): each block owns up to 256 rows of one tile
// (one row per thread, its coordinates in registers for d <= 64; larger
// d re-reads them from global memory) and one contiguous range of the
// leaf's columns, which it stages chunk by chunk in shared memory
// (coordinates point-major for float4 broadcast reads, plus labels).
// Each thread keeps its row's best (d2, label) in registers.  A block
// writes, per row, the 64-bit key (bits(d2) << 32) | (label ^ 2^31):
// d2 >= 0 is never NaN here, so its bits order like an unsigned integer
// (+inf included), and the flipped sign bit orders labels as signed
// integers; the minimum key is the lexicographic minimum of (d2,
// label).  A second small kernel takes the minimum over splits and
// unpacks it.  No atomics; the result does not depend on the split, so
// it equals the plain PyTorch version (ops/query.query_min_core_plain)
// bit for bit.
//
// d2 uses __fsub_rn/__fmul_rn/__fadd_rn, so nothing is contracted into a
// fused multiply-add, and the plain version and the numpy oracle repeat
// the same operations.  Never build this with --use_fast_math.
//
// Bound.  Per (row, slot) pair the kernel spends 3d FP32 operations and
// a compare; it reads each query and each referenced slab once per
// split, so at serving shapes it is bound by FP32 issue, not by memory.
// Every slot of the leaf is visited (no box pruning, as in the TPU
// kernel's exact modes); skipping a leaf's pad tail is later work.
//
// "mixed" (MIXED = 1) adds the TPU kernel's _fast_block_keep prefilter per
// (row group, column chunk): the chunk's box midpoint over its real slots
// (label != INT32_MAX) is the recentring point; each warp runs mma.sync
// over its 32 rows x the chunk's columns in groups of 64 (bf16 operands
// from the bf16 tile routine of bf16_tile.cuh, the rows read from global
// memory, the columns converted from the staged FP32 chunk), and keeps the
// chunk iff some pair of a real query row (every |q_a| < 1e18) and a real
// slot has d2f - band <= eps2, band the per-element bt_band at |q - c|,
// |y - c| (recentred) and |q|, |y| (index frame).  Pad rows and pad slots
// are excluded by these flags, never by the inf/NaN arithmetic their 2e19
// coordinates give.  d2f - band lower-bounds the exact d2, so a chunk that
// could hold a core within eps of some row is always kept and runs the
// exact pass unchanged: a row with such a core gets the exact answer; a
// row without one may keep +inf.  A warp stops at the first group that
// keeps; the block runs the exact pass if any warp kept.  An optional
// pair of 64-bit counters takes [kept, visited] chunks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_tile.cuh"

#define PQ_MAX_THREADS 256
#define PQ_MAX_CHUNK 256
#define PQ_SMEM_BYTES 49152

typedef unsigned long long u64;

__device__ __forceinline__ u64 pq_key(float d2, int label) {
  return ((u64)__float_as_uint(d2) << 32) |
         (u64)((unsigned int)label ^ 0x80000000u);
}

#define PQ_PAD_LIMIT 1e18f
#define PQ_GROUP 64  // columns per prefilter group: 8 n-tiles

template <int DC, int MIXED>
__global__ void __launch_bounds__(PQ_MAX_THREADS) query_leaf_kernel(
    const float* __restrict__ q, const int* __restrict__ tile_leaf,
    const float* __restrict__ coords, const int* __restrict__ labels,
    long long ncols, int d, int qb, int C, int span, int ch,
    long long nrows, float eps2, u64* __restrict__ keep_stats,
    u64* __restrict__ keys) {
  extern __shared__ float4 smem4[];
  const int dp = (d + 3) & ~3;
  float* ys = reinterpret_cast<float*>(smem4);
  int* sv = reinterpret_cast<int*>(ys + (size_t)ch * dp);
  // MIXED: the chunk's centre and its columns' norms and real flags.
  float* ctr = reinterpret_cast<float*>(sv + ch);
  float* cc_s = ctr + dp;
  float* nc_s = cc_s + ch;
  float* gc_s = nc_s + ch;
  int* cr_s = reinterpret_cast<int*>(gc_s + ch);

  const int tile = blockIdx.x;
  const int split = blockIdx.y;
  const int r = blockIdx.z * blockDim.x + threadIdx.x;
  const bool active = r < qb;
  const int row = active ? r : 0;
  const float* qt = q + (size_t)tile * d * qb;

  float xr[DC > 0 ? DC : 1];
  if (DC > 0) {
#pragma unroll
    for (int a = 0; a < DC; ++a) xr[a] = a < d ? qt[(size_t)a * qb + row] : 0.f;
  }

  const long long base = (long long)tile_leaf[tile] * C;
  const int c_begin = split * span;
  const int c_end = min(C, c_begin + span);
  float bd = __int_as_float(0x7f800000);  // +inf
  int bl = 0x7fffffff;

  // MIXED: this row's index-frame norm and whether it is a real query.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wrow0 = blockIdx.z * blockDim.x + warp * 32;  // in the tile
  float gq = 0.f;
  bool qreal = active;
  if (MIXED) {
    float s2 = 0.f;
    if (DC > 0) {
#pragma unroll
      for (int a = 0; a < (DC > 0 ? DC : 1); ++a) {
        if (a >= d) break;
        qreal = qreal && fabsf(xr[a]) < PQ_PAD_LIMIT;
        s2 = __fadd_rn(s2, __fmul_rn(xr[a], xr[a]));
      }
    } else {
      for (int a = 0; a < d; ++a) {
        const float v = qt[(size_t)a * qb + row];
        qreal = qreal && fabsf(v) < PQ_PAD_LIMIT;
        s2 = __fadd_rn(s2, __fmul_rn(v, v));
      }
    }
    gq = __fsqrt_rn(s2);
  }

  for (int j0 = c_begin; j0 < c_end; j0 += ch) {
    const int w = min(ch, c_end - j0);
    __syncthreads();  // the previous chunk is consumed
    for (int t = threadIdx.x; t < w; t += blockDim.x)
      sv[t] = labels[base + j0 + t];
    // Padded axes (d <= a < dp) hold 0 on both sides: each adds +0,
    // which leaves d2 unchanged exactly.
    for (int e = threadIdx.x; e < dp * w; e += blockDim.x) {
      const int a = e / w;
      const int t = e - a * w;
      ys[t * dp + a] = a < d ? coords[(size_t)a * ncols + base + j0 + t] : 0.f;
    }
    __syncthreads();
    if (MIXED) {
      // The centre: each warp takes axes a = warp, warp + nw, ...
      const int nw = blockDim.x >> 5;
      for (int a = warp; a < d; a += nw) {
        float lo = __int_as_float(0x7f800000), hi = -lo;
        for (int t = lane; t < w; t += 32) {
          if (sv[t] == 0x7fffffff) continue;
          const float v = coords[(size_t)a * ncols + base + j0 + t];
          lo = fminf(lo, v);
          hi = fmaxf(hi, v);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
          hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        }
        if (lane == 0) ctr[a] = hi >= lo ? __fmul_rn(0.5f, __fadd_rn(hi, lo))
                                         : 0.f;
      }
      __syncthreads();
      for (int t = threadIdx.x; t < ch; t += blockDim.x) {
        const bool real = t < w && sv[t] != 0x7fffffff;
        float s1 = 0.f, s2 = 0.f;
        if (real) {
          for (int a = 0; a < d; ++a) {
            const float y = ys[t * dp + a];
            const float df = __fsub_rn(y, ctr[a]);
            s1 = __fadd_rn(s1, __fmul_rn(df, df));
            s2 = __fadd_rn(s2, __fmul_rn(y, y));
          }
        }
        cc_s[t] = s1;
        nc_s[t] = __fsqrt_rn(s1);
        gc_s[t] = __fsqrt_rn(s2);
        cr_s[t] = real;
      }
      // This row's recentred norm, then the four fragment rows' values.
      float xx = 0.f;
      if (DC > 0) {
#pragma unroll
        for (int a = 0; a < (DC > 0 ? DC : 1); ++a) {
          if (a >= d) break;
          const float df = __fsub_rn(xr[a], ctr[a]);
          xx = __fadd_rn(xx, __fmul_rn(df, df));
        }
      } else {
        for (int a = 0; a < d; ++a) {
          const float df = __fsub_rn(qt[(size_t)a * qb + row], ctr[a]);
          xx = __fadd_rn(xx, __fmul_rn(df, df));
        }
      }
      __syncthreads();
      float rxx[2][2], rnq[2][2], rgq[2][2];
      bool rre[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int src = mt * 16 + h * 8 + g;
          rxx[mt][h] = __shfl_sync(0xffffffffu, xx, src);
          rnq[mt][h] = __fsqrt_rn(rxx[mt][h]);
          rgq[mt][h] = __shfl_sync(0xffffffffu, gq, src);
          rre[mt][h] = __shfl_sync(0xffffffffu, (int)qreal, src) != 0;
        }
      }
      bool keep = false;
      for (int c0 = 0; c0 < w && !keep; c0 += PQ_GROUP) {
        float acc[2][PQ_GROUP / 8][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < PQ_GROUP / 8; ++j)
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
                         ? __fsub_rn(qt[(size_t)a * qb + rr], ctr[a])
                         : 0.f;
            }
            af[mt][0] = bt_pack(v[0], v[1]);
            af[mt][1] = bt_pack(v[2], v[3]);
            af[mt][2] = bt_pack(v[4], v[5]);
            af[mt][3] = bt_pack(v[6], v[7]);
          }
#pragma unroll
          for (int j = 0; j < PQ_GROUP / 8; ++j) {
            const int col = c0 + j * 8 + g;
            float v[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int a = k0 + t4 * 2 + (i & 1) + (i >> 1) * 8;
              v[i] = (a < d && col < w) ? __fsub_rn(ys[col * dp + a], ctr[a])
                                        : 0.f;
            }
            const unsigned b[2] = {bt_pack(v[0], v[1]), bt_pack(v[2], v[3])};
            bt_mma(acc[0][j], af[0], b);
            bt_mma(acc[1][j], af[1], b);
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int j = 0; j < PQ_GROUP / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1;
              const int col = c0 + j * 8 + t4 * 2 + (e & 1);
              if (col >= w || !rre[mt][h] || !cr_s[col]) continue;
              const float d2f = bt_d2f(rxx[mt][h], cc_s[col], acc[mt][j][e]);
              const float band = bt_band(rnq[mt][h], nc_s[col], rgq[mt][h],
                                         gc_s[col]);
              keep = keep || __fsub_rn(d2f, band) <= eps2;
            }
        keep = __any_sync(0xffffffffu, keep);
      }
      const bool run = __syncthreads_or(keep) != 0;
      if (keep_stats && threadIdx.x == 0) {
        atomicAdd(keep_stats, (u64)run);
        atomicAdd(keep_stats + 1, (u64)1);
      }
      if (!run) continue;
    }
    if (!active) continue;
    for (int t = 0; t < w; ++t) {
      const float* y = ys + t * dp;
      float d2 = 0.f;
      if (DC > 0) {
#pragma unroll
        for (int k = 0; k < DC / 4; ++k) {
          if (4 * k < d) {
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
          const float df = __fsub_rn(__ldg(qt + (size_t)a * qb + row), y[a]);
          d2 = __fadd_rn(d2, __fmul_rn(df, df));
        }
      }
      const int v = sv[t];
      if (d2 < bd || (d2 == bd && v < bl)) {
        bd = d2;
        bl = v;
      }
    }
  }
  if (active)
    keys[(size_t)split * nrows + (size_t)tile * qb + r] = pq_key(bd, bl);
}

// Minimum key over the splits, unpacked into [labels, bits(d2)].
__global__ void query_fold_kernel(const u64* __restrict__ keys, int splits,
                                  long long nrows, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nrows) return;
  u64 k = keys[i];
  for (int s = 1; s < splits; ++s) {
    const u64 o = keys[(size_t)s * nrows + i];
    k = o < k ? o : k;
  }
  out[i] = (int)((unsigned int)(k & 0xffffffffu) ^ 0x80000000u);
  out[nrows + i] = (int)(unsigned int)(k >> 32);
}

template <int DC>
static int launch_dc(dim3 grid, int threads, size_t smem, cudaStream_t s,
                     const float* q, const int* tile_leaf,
                     const float* coords, const int* labels, long long ncols,
                     int d, int qb, int C, int span, int ch, long long nrows,
                     float eps2, int mixed, u64* keep_stats, u64* keys) {
  if (mixed) {
    cudaError_t err = cudaFuncSetAttribute(
        query_leaf_kernel<DC, 1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    query_leaf_kernel<DC, 1><<<grid, threads, smem, s>>>(
        q, tile_leaf, coords, labels, ncols, d, qb, C, span, ch, nrows, eps2,
        keep_stats, keys);
  } else {
    query_leaf_kernel<DC, 0><<<grid, threads, smem, s>>>(
        q, tile_leaf, coords, labels, ncols, d, qb, C, span, ch, nrows, eps2,
        nullptr, keys);
  }
  return (int)cudaGetLastError();
}

extern "C" {

// Scratch keys the wrapper allocates: splits * nqt * qb u64 (8 bytes).
int pp_query_splits(int nqt, int qb, int C) {
  const int groups = (qb + PQ_MAX_THREADS - 1) / PQ_MAX_THREADS;
  const long long blocks = (long long)nqt * groups;
  // Aim at ~8 blocks per SM of an H100, each with at least two chunks.
  long long splits = (8LL * 132 + blocks - 1) / blocks;
  const long long most = (C + 2 * PQ_MAX_CHUNK - 1) / (2 * PQ_MAX_CHUNK);
  if (splits > most) splits = most;
  if (splits > 64) splits = 64;
  if (splits < 1) splits = 1;
  return (int)splits;
}

// B5.  q (nqt, d, qb) float32; tile_leaf (nqt,) int32; coords (d, ncols)
// float32 with ncols = L * C; labels (ncols,) int32; eps2 the float32
// eps^2 and mixed 1 for the "mixed" prefilter (0: every chunk runs);
// keep_stats NULL or two uint64 counters [kept, visited] the caller
// zeroed; keys scratch of splits * nqt * qb u64 (splits from
// pp_query_splits); out (2, nqt, qb) int32.  Returns the cudaError_t of
// the launches.
int pp_query_leaf(const float* q, const int* tile_leaf, const float* coords,
                  const int* labels, long long ncols, int nqt, int d, int qb,
                  int C, int splits, float eps2, int mixed, void* keep_stats,
                  void* keys, int* out, void* stream) {
  if (nqt <= 0 || qb <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int dp = (d + 3) & ~3;
  int ch = PQ_SMEM_BYTES / (4 * (dp + 1));
  if (ch > PQ_MAX_CHUNK) ch = PQ_MAX_CHUNK;
  if (ch < 1) ch = 1;
  // MIXED adds the centre and four per-column arrays.
  const size_t smem = (size_t)ch * dp * 4 + (size_t)ch * 4 +
                      (mixed ? (size_t)dp * 4 + (size_t)ch * 16 : 0);
  u64* ks = reinterpret_cast<u64*>(keep_stats);
  int threads = ((qb + 31) / 32) * 32;
  if (threads > PQ_MAX_THREADS) threads = PQ_MAX_THREADS;
  const int groups = (qb + threads - 1) / threads;
  // Columns per split, a whole number of chunks.
  int span = (C + splits - 1) / splits;
  span = ((span + ch - 1) / ch) * ch;
  if (span < 1) span = 1;
  const long long nrows = (long long)nqt * qb;
  u64* k = reinterpret_cast<u64*>(keys);
  const dim3 grid(nqt, splits, groups);
  int rc;
  if (d <= 4)
    rc = launch_dc<4>(grid, threads, smem, s, q, tile_leaf, coords, labels,
                      ncols, d, qb, C, span, ch, nrows, eps2, mixed, ks, k);
  else if (d <= 8)
    rc = launch_dc<8>(grid, threads, smem, s, q, tile_leaf, coords, labels,
                      ncols, d, qb, C, span, ch, nrows, eps2, mixed, ks, k);
  else if (d <= 16)
    rc = launch_dc<16>(grid, threads, smem, s, q, tile_leaf, coords, labels,
                       ncols, d, qb, C, span, ch, nrows, eps2, mixed, ks, k);
  else if (d <= 32)
    rc = launch_dc<32>(grid, threads, smem, s, q, tile_leaf, coords, labels,
                       ncols, d, qb, C, span, ch, nrows, eps2, mixed, ks, k);
  else if (d <= 64)
    rc = launch_dc<64>(grid, threads, smem, s, q, tile_leaf, coords, labels,
                       ncols, d, qb, C, span, ch, nrows, eps2, mixed, ks, k);
  else
    rc = launch_dc<0>(grid, threads, smem, s, q, tile_leaf, coords, labels,
                      ncols, d, qb, C, span, ch, nrows, eps2, mixed, ks, k);
  if (rc != 0) return rc;
  const int ft = 256;
  query_fold_kernel<<<(unsigned)((nrows + ft - 1) / ft), ft, 0, s>>>(
      k, splits, nrows, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
