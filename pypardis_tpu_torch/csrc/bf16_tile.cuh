// The bf16 tile routine shared by the precision modes of the Hopper
// kernels (pair_kernels.cu, sketch_kernels.cu, query_kernels.cu).
//
// Form.  A fast squared distance is
//     d2f = (|x - c|^2 + |y - c|^2) - 2 * bf16(x - c) . bf16(y - c)
// with c a recentring point (the row tile's box centre in the fit, the
// column chunk's box midpoint in serving): the cross term runs on the
// tensor cores (mma.sync m16n8k16, bf16 operands, FP32 accumulators,
// K = d padded to 16 with zeros), the squared norms are FP32 sums of the
// unrounded recentred coordinates, taken in the epilogue.  This is the
// XLA form of the JAX package, not the augmented-operand form of its
// Pallas kernels: the norms need no bf16 rounding, K stays d (not d + 2,
// which would cost a whole extra k-step at d = 16), and the
// band_halfwidth derivation (pypardis_tpu/ops/precision.py) covers it:
// only the cross term carries bf16 operand rounding, bounded by
// 2^-7 |x - c| |y - c| under Cauchy-Schwarz, and the bound's
// 2^-9 (nx^2 + ny^2) term is left as slack for the FP32 sums.
// Recentring keeps |x - c| at the tile's own scale, so the band is a few
// per cent of eps^2 rather than of the data's extent.
//
// Every rounding here is explicit (__fadd_rn and friends, RN conversions
// to bf16), so the plain PyTorch versions repeat the same operations and
// differ from the kernels only in the order in which the tensor cores
// sum the 16-term products.  Never build with --use_fast_math.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Two floats rounded to bf16 (nearest even) and packed, the lower index
// in the low half: one 32-bit register of an mma fragment.
__device__ __forceinline__ unsigned bt_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// D += A * B for one m16n8k16 tile: A 16x16 row-major (a[0..3]), B 16x8
// column-major (b[0..1]), D 16x8 FP32 (c[0..3]).  Fragment layout, with
// g = lane / 4 and t = lane % 4:
//   a[0] = A[g][2t, 2t+1]      a[1] = A[g+8][2t, 2t+1]
//   a[2] = A[g][2t+8, 2t+9]    a[3] = A[g+8][2t+8, 2t+9]
//   b[0] = B[2t, 2t+1][g]      b[1] = B[2t+8, 2t+9][g]
//   c[0] = D[g][2t]  c[1] = D[g][2t+1]  c[2] = D[g+8][2t]  c[3] = D[g+8][2t+1]
__device__ __forceinline__ void bt_mma(float* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d2f from the two squared norms and the tensor-core cross term.
__device__ __forceinline__ float bt_d2f(float xx, float yy, float dot) {
  return __fsub_rn(__fadd_rn(xx, yy), __fmul_rn(2.f, dot));
}

// The classification band of one pair or tile pair: band_halfwidth at
// the recentred norms nx, ny plus exact_slack at the frame norms gx, gy,
//   1.25 * ((2^-7 nx) ny + 2^-9 (nx nx + ny ny)) + (2^-16 (gx + gy)) (gx + gy),
// each operation in float32 in the order ops/distances.fast_band takes it.
__device__ __forceinline__ float bt_band(float nx, float ny, float gx,
                                         float gy) {
  const float bh = __fmul_rn(
      1.25f,
      __fadd_rn(__fmul_rn(__fmul_rn(0x1p-7f, nx), ny),
                __fmul_rn(0x1p-9f,
                          __fadd_rn(__fmul_rn(nx, nx), __fmul_rn(ny, ny)))));
  const float s = __fadd_rn(gx, gy);
  return __fadd_rn(bh, __fmul_rn(__fmul_rn(0x1p-16f, s), s));
}
