// mma.cuh — the tensor cores' 3xTF32 product, the primitives every
// tensor-core kernel of the port builds on (cnn_mma.cuh: the patch-CNN
// tower; lstm_mma.cuh: the LSTM gate block; update.cu, acting.cu and
// tower_mma.cuh: the MLP towers of K3, K5 and K2).
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
// cvt.rna.tf32, which rounds ties away at 10 bits). Two forms:
//   - one TF32 product of the rounded operands widened back (split_op,
//     mma_op with BF16): a bf16 value is a TF32 value and the product of
//     two is exact in fp32, so one product a k-step of 8 where 3xTF32 takes
//     three. K7's dense arm's weight products take it (bf16x2 rows).
//   - the bf16 tensor cores' own product, mma.sync.aligned.m16n8k16.row.
//     col.f32.bf16.bf16.f32 (mma_bf16): a warp multiplies a 16 x 16 tile by
//     a 16 x 8 one, at twice the TF32 instruction's rate, from operands
//     stored once as bf16 pairs (bf16x2: the lower k in the lower half),
//     loaded from shared memory by ldmatrix (ldsm_x4, ldsm_x4_t, .trans for
//     rows stored k-major) with no conversion in the inner loop. Each
//     product of two bf16 values is exact in fp32 under either
//     instruction; this one adds 16 products in a group where the other
//     added 8: the same class of non-IEEE accumulation (ROADMAP H10, H12).
//     The patch-CNN tower's bf16 arm (cnn_mma.cuh), the bf16 weight
//     products of K10 and K7's CNN arm (grad_b16_tile), K7's walk and the
//     bf16 arms of K3 (update.cu) and K2 (tower_mma.cuh) take it.
// The folds of long sums stay in both.
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

// d += A B, A 16 x 16 bf16 (four bf16x2 registers: rows g and g + 8 of
// columns 2t, 2t + 1, then of 2t + 8, 2t + 9), B 16 x 8 (two: rows 2t, 2t +
// 1 and 2t + 8, 2t + 9 of column g), d as mma_tf32's.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// {bf16(lo), bf16(hi)} (nearest even), lo in the lower half.
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// x's bf16 bits (nearest even).
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return (uint16_t)(bf16_rn(x) >> 16);
}

// Four 8 x 8 matrices of 16-bit values from shared memory, each row 16
// bytes at the address lane 8 i + r gives for row r of matrix i: lane l
// receives row l / 4, values 2 (l % 4), + 1 of each (ldsm_x4), or with
// .trans row 2 (l % 4), + 1 of column l / 4 (ldsm_x4_t).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
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

// The bf16 arms' weight-gradient product, one block of 256 threads: the
// 64 x 64 tile C[m][n] = sum over CK samples of A[m][s] B[n][s] (rows m0 ..
// of A's M and n0 .. of B's N; a and b at row 0 of the chunk's first
// sample, rows NL floats apart; rows past M or N read as zeros), each
// window of GB_T samples summed from zero by m16n8k16 products and folded
// into the chunk's total with IEEE adds; with bias, the fp32 sums of A's
// rows beside it. A window's operands are rounded once into bf16 rows of
// shared memory (sm: GB_SMEM bytes, two windows of A and B, GB_S bf16 a
// row), the next window's float4s loading while one multiplies, one barrier
// a window; the bias sums come from the loaded float4s (warp butterflies
// over the 16 lanes of a row). Warp w takes rows 32 (w & 1) .., columns 16
// (w >> 1) ... Writes C into the (M, W) row-major block at out (columns n,
// the bias sums in column N). CK a multiple of GB_T.
constexpr int GB_T = 64;
constexpr int GB_S = 72;
constexpr int GB_SMEM = 2 * 2 * GB_T * GB_S * 2;  // 36,864

__device__ __forceinline__ void grad_b16_tile(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              int M, int N, int NL, int CK,
                                              int m0, int n0, bool bias,
                                              uint16_t* sm, float* out,
                                              int W) {
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3, r8 = lane & 7, q8 = lane >> 3;
  const int wm = 32 * (w & 1), wn = 16 * (w >> 1);
  // this thread's float4s of a window: element e = tid + 256 q, row e / 16,
  // samples 4 (e % 16) ..
  constexpr int NQ = GB_T * GB_T / 4 / 256;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 ra[NQ], rb[NQ];
  float sum[2][2][4], bsum[NQ];
  zero_frags(sum);
#pragma unroll
  for (int q = 0; q < NQ; ++q) bsum[q] = 0.0f;
  auto load = [&](int s0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int e = tid + 256 * q, row = e / 16, col = 4 * (e % 16);
      ra[q] = m0 + row < M ? __ldg(reinterpret_cast<const float4*>(
                                 a + (size_t)(m0 + row) * NL + s0 + col))
                           : zero4;
      rb[q] = n0 + row < N ? __ldg(reinterpret_cast<const float4*>(
                                 b + (size_t)(n0 + row) * NL + s0 + col))
                           : zero4;
    }
  };
  load(0);
  int buf = 0;
  for (int s0 = 0; s0 < CK; s0 += GB_T) {
    uint16_t* As = sm + buf * 2 * GB_T * GB_S;
    uint16_t* Bs = As + GB_T * GB_S;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int e = tid + 256 * q, row = e / 16, col = 4 * (e % 16);
      *reinterpret_cast<uint2*>(As + row * GB_S + col) =
          make_uint2(bf16x2(ra[q].x, ra[q].y), bf16x2(ra[q].z, ra[q].w));
      *reinterpret_cast<uint2*>(Bs + row * GB_S + col) =
          make_uint2(bf16x2(rb[q].x, rb[q].y), bf16x2(rb[q].z, rb[q].w));
      if (bias) {
        float v = (ra[q].x + ra[q].y) + (ra[q].z + ra[q].w);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          v = v + __shfl_xor_sync(0xffffffffu, v, o);
        bsum[q] = bsum[q] + v;
      }
    }
    __syncthreads();
    if (s0 + GB_T < CK) load(s0 + GB_T);
    // the window's sums in fresh accumulators, folded into the chunk's
    float acc[2][2][4];
    zero_frags(acc);
#pragma unroll
    for (int k0 = 0; k0 < GB_T; k0 += 16) {
      uint32_t fa[2][4], fb[2][2], v[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4(fa[i], As + (wm + 16 * i + r8 + 8 * (q8 & 1)) * GB_S + k0 +
                           8 * (q8 >> 1));
      ldsm_x4(v, Bs + (wn + r8 + 8 * (q8 >> 1)) * GB_S + k0 + 8 * (q8 & 1));
      fb[0][0] = v[0];
      fb[0][1] = v[1];
      fb[1][0] = v[2];
      fb[1][1] = v[3];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16(acc[i][j], fa[i], fb[j]);
    }
    fold(sum, 0, acc);
    buf ^= 1;  // the other buffer's last readers passed this window's barrier
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + 16 * i + g + (r & 2 ? 8 : 0);
        const int c = n0 + wn + 8 * j + 2 * tq + (r & 1);
        if (m < M && c < N) out[(size_t)m * W + c] = sum[i][j][r];
      }
  if (bias && (tid & 15) == 0)
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int m = m0 + tid / 16 + 16 * q;
      if (m < M) out[(size_t)m * W + N] = bsum[q];
    }
}

}  // namespace drone
