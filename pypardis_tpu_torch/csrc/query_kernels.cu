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

#include <cuda_runtime.h>
#include <stdint.h>

#define PQ_MAX_THREADS 256
#define PQ_MAX_CHUNK 256
#define PQ_SMEM_BYTES 49152

typedef unsigned long long u64;

__device__ __forceinline__ u64 pq_key(float d2, int label) {
  return ((u64)__float_as_uint(d2) << 32) |
         (u64)((unsigned int)label ^ 0x80000000u);
}

template <int DC>
__global__ void __launch_bounds__(PQ_MAX_THREADS) query_leaf_kernel(
    const float* __restrict__ q, const int* __restrict__ tile_leaf,
    const float* __restrict__ coords, const int* __restrict__ labels,
    long long ncols, int d, int qb, int C, int span, int ch,
    long long nrows, u64* __restrict__ keys) {
  extern __shared__ float4 smem4[];
  const int dp = (d + 3) & ~3;
  float* ys = reinterpret_cast<float*>(smem4);
  int* sv = reinterpret_cast<int*>(ys + (size_t)ch * dp);

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
static void launch_dc(dim3 grid, int threads, size_t smem, cudaStream_t s,
                      const float* q, const int* tile_leaf,
                      const float* coords, const int* labels,
                      long long ncols, int d, int qb, int C, int span,
                      int ch, long long nrows, u64* keys) {
  query_leaf_kernel<DC><<<grid, threads, smem, s>>>(
      q, tile_leaf, coords, labels, ncols, d, qb, C, span, ch, nrows, keys);
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
// float32 with ncols = L * C; labels (ncols,) int32; keys scratch of
// splits * nqt * qb u64 (splits from pp_query_splits); out (2, nqt, qb)
// int32.  Returns the cudaError_t of the launches.
int pp_query_leaf(const float* q, const int* tile_leaf, const float* coords,
                  const int* labels, long long ncols, int nqt, int d, int qb,
                  int C, int splits, void* keys, int* out, void* stream) {
  if (nqt <= 0 || qb <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int dp = (d + 3) & ~3;
  int ch = PQ_SMEM_BYTES / (4 * (dp + 1));
  if (ch > PQ_MAX_CHUNK) ch = PQ_MAX_CHUNK;
  if (ch < 1) ch = 1;
  const size_t smem = (size_t)ch * dp * 4 + (size_t)ch * 4;
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
  if (d <= 4)
    launch_dc<4>(grid, threads, smem, s, q, tile_leaf, coords, labels, ncols,
                 d, qb, C, span, ch, nrows, k);
  else if (d <= 8)
    launch_dc<8>(grid, threads, smem, s, q, tile_leaf, coords, labels, ncols,
                 d, qb, C, span, ch, nrows, k);
  else if (d <= 16)
    launch_dc<16>(grid, threads, smem, s, q, tile_leaf, coords, labels,
                  ncols, d, qb, C, span, ch, nrows, k);
  else if (d <= 32)
    launch_dc<32>(grid, threads, smem, s, q, tile_leaf, coords, labels,
                  ncols, d, qb, C, span, ch, nrows, k);
  else if (d <= 64)
    launch_dc<64>(grid, threads, smem, s, q, tile_leaf, coords, labels,
                  ncols, d, qb, C, span, ch, nrows, k);
  else
    launch_dc<0>(grid, threads, smem, s, q, tile_leaf, coords, labels, ncols,
                 d, qb, C, span, ch, nrows, k);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int ft = 256;
  query_fold_kernel<<<(unsigned)((nrows + ft - 1) / ft), ft, 0, s>>>(
      k, splits, nrows, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
