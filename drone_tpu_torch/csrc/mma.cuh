// mma.cuh — the tensor cores' 3xTF32 product, the primitives every
// tensor-core kernel of the port builds on (cnn_mma.cuh: the patch-CNN
// tower; lstm_mma.cuh: the LSTM gate block; update.cu and acting.cu: the
// MLP towers of K3 and K5).
//
// Instruction: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (a warp
// multiplies a 16 x 8 tile by an 8 x 8 one). Precision, 3xTF32: each fp32
// operand x is split into big = cvt.rna.tf32(x) and small =
// cvt.rna.tf32(x - big) (exact with --fmad=false), and a product
// accumulates small.big + big.small + big.big in the tensor cores' fp32
// accumulators. The error of a product is ~2^-21 of its size, against
// fp32's 2^-24; a sum over many samples starts each window of 64 from zero
// and is added to its running total with IEEE adds (fold).
//
// The bf16 arm (compute_dtype="bfloat16": the reference's _dot32 casts both
// operands of a product to bfloat16 and accumulates in fp32,
// drone_tpu/ops/pallas_acting.py): each operand is rounded once to bf16 by
// cvt.rn.bf16x2.f32 (round to nearest even, as XLA's convert rounds; not
// cvt.rna.tf32, which rounds ties away at 10 bits) and widened back. A bf16
// value is a TF32 value (8 significant bits of TF32's 11) and the product
// of two is exact in fp32, so one TF32 product of the rounded operands
// computes _dot32's product: one product a k-step where 3xTF32 takes three,
// and no split. The kernels take the precision as a template parameter,
// BF16 (split_op, mma_op); the folds of long sums stay.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace drone {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// big's low 13 bits are cleared, as x - big must see the TF32 value the
// tensor cores multiply; small's are left, as the tensor cores ignore them.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x) & 0xffffe000u;
  small = tf32_rna(x - __uint_as_float(big));
}

// x rounded to bf16 (nearest even), widened to its fp32 bits: the upper
// half of a bf16x2 pair whose lower half is bf16(0) = 0.
__device__ __forceinline__ uint32_t bf16_rn(float x) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(x), "f"(0.0f));
  return r;
}

// An operand of a product: 3xTF32's (big, small) split, or with BF16 the
// bf16 rounding as big and no small (mma_op reads only big).
template <bool BF16>
__device__ __forceinline__ void split_op(float x, uint32_t& big,
                                         uint32_t& small) {
  if constexpr (BF16) {
    big = bf16_rn(x);
    small = 0u;
  } else {
    split_tf32(x, big, small);
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j] += A_i B_j in 3xTF32, pass by pass over the tiles (the three
// products of one tile depend on each other; the tiles do not).
template <int MI, int NI>
__device__ __forceinline__ void mma3(float (&acc)[MI][NI][4],
                                     const uint32_t (&ab)[MI][4],
                                     const uint32_t (&as)[MI][4],
                                     const uint32_t (&bb)[NI][2],
                                     const uint32_t (&bs)[NI][2]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) mma_tf32(acc[i][j], as[i], bb[j]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) mma_tf32(acc[i][j], ab[i], bs[j]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) mma_tf32(acc[i][j], ab[i], bb[j]);
}

// acc[i][j] += A_i B_j: mma3 in 3xTF32, or with BF16 the one product of
// the rounded operands.
template <bool BF16, int MI, int NI>
__device__ __forceinline__ void mma_op(float (&acc)[MI][NI][4],
                                       const uint32_t (&ab)[MI][4],
                                       const uint32_t (&as)[MI][4],
                                       const uint32_t (&bb)[NI][2],
                                       const uint32_t (&bs)[NI][2]) {
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_tf32(acc[i][j], ab[i], bb[j]);
  } else {
    mma3(acc, ab, as, bb, bs);
  }
}

// x as the bf16 arm's CUDA-core products take an operand (rounded to bf16
// and widened), or x itself.
template <bool BF16>
__device__ __forceinline__ float op_value(float x) {
  if constexpr (BF16)
    return __uint_as_float(bf16_rn(x));
  else
    return x;
}

template <int MI, int NI>
__device__ __forceinline__ void zero_frags(float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;
}

// g[i][NI * part + j] += acc[i][j], IEEE adds. The tensor cores' own
// accumulation is not fp32's round-to-nearest: over a block's thousands of
// samples its error would grow with the sum, so a window's sums start from
// zero and are added here.
template <int MI, int NG, int NI>
__device__ __forceinline__ void fold(float (&g)[MI][NG][4], int part,
                                     const float (&acc)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        g[i][NI * part + j][r] = g[i][NI * part + j][r] + acc[i][j][r];
}

}  // namespace drone
