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
