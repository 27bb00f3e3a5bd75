// The label-bound walk's search, shared by the min-label kernels B2
// (pair_kernels.cu) and B4 (sketch_kernels.cu), and the 4-byte cp.async
// both stage with.  The rule it serves is in pair_kernels.cu's header:
// a block passes over every 32-column chunk whose least label is not
// below its bound, and over every pair-list entry whose column tile's
// least label is not.

#pragma once

#include <cuda_runtime.h>

#define LB_CHUNK 32  // columns per chunk of the walk
#define LB_INT_INF 2147483647

// 4-byte cp.async into shared memory (src_size 0: zero-fill).
__device__ __forceinline__ void lb_cp4(void* dst, const void* src,
                                      int src_size) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_size));
}

// From chunk (p, j0) on, the first chunk whose least label L is below the
// bound bnd, passing over whole entries whose column tile's least label
// (tile_min) is not.  Every warp reads the same labels and takes a
// __reduce_min_sync, so the result is uniform over the block without a
// barrier.  Returns false (p == p1) when none is left.
__device__ __forceinline__ bool lb_find(
    const int* __restrict__ colval, const int* __restrict__ cols,
    const int* __restrict__ tile_min, int tile, int p1, int bnd, int& p,
    int& j0, int& L) {
  const int lane = threadIdx.x & 31;
  for (; p < p1; ++p, j0 = 0) {
    const int ct = __ldg(cols + p);
    if (__ldg(tile_min + ct) >= bnd) continue;
    const long long c0 = (long long)ct * tile;
    for (; j0 < tile; j0 += LB_CHUNK) {
      const int v = lane < min(LB_CHUNK, tile - j0)
                        ? __ldg(colval + c0 + j0 + lane)
                        : LB_INT_INF;
      L = __reduce_min_sync(0xffffffffu, v);
      if (L < bnd) return true;
    }
  }
  return false;
}
