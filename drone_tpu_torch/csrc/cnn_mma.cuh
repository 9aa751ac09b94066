// cnn_mma.cuh — the patch-CNN tower over a tile of samples on the tensor
// cores, in 3xTF32: the one tower forward of the port (tower_fwd_tile), run
// by the acting kernels (acting_cnn.cu: K11 and K9; the CNN arms of
// acting_lstm.cu: K8 and K6) once a step and by the updates (update_cnn.cu:
// K10; update_lstm.cu: K7's CNN arm) once a sample, and the tower's
// backward (tower_bwd_tile, the updates').
//
// Each layer is the matrix product it is, over samples x positions:
//   conv0   (samples . 36, 64)  x (64, 64)
//   conv1   (samples . 9, 256)  x (256, 64)
//   trunk   (samples, 576)      x (576, 128)
// and in the backward dX2 = dzt Wt (masked by conv1's relu), dX1 = dz1 W1
// (masked by conv0's relu), and gW1, gW0 as products over the samples.
// The render (splat12, render_patch, IEEE expf) stays on the CUDA cores
// with cnn.cuh's arithmetic, and the backward re-renders and re-runs conv0:
// conv0's output would take ~19 GB a minibatch.
//
// Instruction: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (a warp
// multiplies a 16 x 8 tile by an 8 x 8 one). It takes its fragments from
// registers in any layout, so the activations stay in shared memory as
// rows of the tile ([row][sample], stride TM_S) for the forward products
// (M = samples, K = rows) and the weight-gradient ones (K = samples) alike.
// wgmma would need the activations K-major in shared memory and its
// descriptors; mma.sync keeps the layout the render and the heads share.
//
// Precision, 3xTF32: each fp32 operand x is split into big = cvt.rna.tf32(x)
// and small = cvt.rna.tf32(x - big) (exact with --fmad=false), and a
// product accumulates small.big + big.small + big.big in the tensor cores'
// fp32 accumulators. The error of a product is ~2^-21 of its size, against
// fp32's 2^-24; the weight gradients' sums over a block's samples add each
// window's partial sums with IEEE adds (fold). The updates are held to
// their fp32 plain versions at the update's tolerance (1e-4 of each
// gradient tensor's max), the acting kernels at the serving one (rtol 2e-5,
// atol 2e-6 over 3 steps). Plain TF32 or bf16 would not hold them.
//
// The bf16 arm (compute_dtype="bfloat16", the reference's cnn_encode,
// cnn_forward and cnn_encoder_bwd with _dot32 rounding both operands of
// every product) is a design of its own on the bf16 tensor cores
// (tower_fwd_b16, tower_bwd_b16; mma.cuh mma_bf16, m16n8k16): every row of
// the tile that only products read is stored once as bf16 ([row][sample],
// TMB bf16 a row) by the store that writes it (the render, conv0's relu,
// conv1's relu beside its fp32 copy, the loaded dzt, dz1, dz0), and its
// fragments load by ldmatrix (.trans where the rows are the product's k)
// with no conversion in the inner loops; the weights are packed once a call
// as bf16x2 fragments of m16n8k16, a uint4 a lane holding two n-tiles
// (pack_tower_kernel<true>, PKB_*), a quarter of the 3xTF32 pack. What the
// bias adds, the heads and the bias sums read stays fp32: the splat
// scalars, conv1's output as the X2 scratch copies it, h, and the bias sums
// of dz1 and dz0, which their epilogues sum from the fp32 values in
// registers. A relu mask is the fp32 value's: conv0's relu stores a
// positive output that rounds to bf16 zero as -0 (a zero operand all the
// same), so the backward's mask is the stored bits being nonzero. The
// forward stages W0's and W1's fragments (40 KB) in shared memory and h
// goes over the dead y0 and y1 rows (108,928 bytes, two blocks an SM); the
// backward's rows take 107,904 bytes, TBB_PER_SM blocks an SM. K11, K9,
// K10 and K7's CNN arm take it; the CNN arms of K8 and K6 are fp32 only.
//
// Weights: pack_tower_kernel splits the tower's weights once per call into
// (big, small) fragments in the order a warp reads them (a float4 a lane a
// k x n tile: 512 contiguous bytes). The forward stages W0's 32 KB in each
// block's shared memory (tower_load_w0): conv0 runs 36 times a sample and
// is 40% of the forward's products. W1's and Wt's fragments (704 KB) stay
// in L2 and L1, the next k-step's loaded into registers while a step
// multiplies (mma_rows_packed; the backward, at one block an SM, loads two
// ahead). The activations are split as their fragments load.
//
// The forward (tower_fwd_tile), patch by patch with one barrier each: while
// conv0 multiplies patch j, the block renders patch j + 1 into the other of
// two patch buffers, so one warp's render overlaps another's products
// (besides the two blocks an SM); conv1 adds each patch's 64 inputs into
// sums held in registers as the patch's conv0 output arrives, so only two
// patches' conv0 outputs are ever live (128 rows, later h), not a window's
// four; at a window's end its conv1 output goes over the patch buffer conv0
// has read, and the trunk adds the window's share. Each product sums its
// k-steps in the order it did when the forward ran window by window, so
// the updates' gradients kept their bits. Shared memory 109,952 bytes (two
// blocks an SM, which the acting kernel K11 needs: at one, 28% slower),
// 55 barriers a tile (81 before). Not taken: 128-sample tiles (twice the
// rows, and twice the accumulators in registers capped at 128 a thread by
// the second block), W1's and Wt's fragments staged in shared memory (no
// room beside two tiles), wgmma (the activations K-major, in place of the
// rows the render and the heads share), the render interleaved between
// conv0's k-steps (K11 5% slower, K8's CNN arm 4%), and W1's and Wt's
// fragments loaded two k-steps ahead (K11 0.5% faster, K8's and K7's CNN
// arms 1% slower). Their times: PERF.md.

// Tiles: 64 samples, 8 warps. The backward 206,208 bytes (one block an SM;
// its weight gradients stay in registers, 80 a thread, across all its
// tiles); the bf16 arm's 107,904.
//
// Determinism (H6): no float atomics. Every product accumulates in a fixed
// order, each block keeps its weight gradients in a fixed per-thread
// ownership across its tiles and writes its own partial row, and the bias
// sums are warp butterflies (every lane ends with the same bits).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cnn.cuh"
#include "mma.cuh"

namespace drone {

constexpr int TM_L = 64;        // samples of a tile
constexpr int TM_S = 72;        // row stride: 8 mod 32, so a forward
                                // A fragment's 32 reads hit 32 banks
constexpr int TM_THREADS = 256;
// A 64 x 64 product's warp tile: CMI m-tiles x CNI n-tiles, CMW warps
// along the samples. One A fragment feeds four n-tiles, so a warp splits
// half the operands it would at 2 x 2 (K10 5% faster on an H100).
constexpr int CMI = 1, CNI = 4, CMW = 4;

// The packed weights, in float4s: B[k][n] fragments of each product
constexpr int PK_W0 = 0;                        // conv0: B = W0^T (64, 64)
constexpr int PK_W1 = PK_W0 + CNN_K0 * CNN_C0 / 2;     // conv1: W1^T (256, 64)
constexpr int PK_WT = PK_W1 + CNN_K1 * CNN_C1 / 2;     // trunk: Wt^T (576, 128)
constexpr int PK_WTB = PK_WT + CNN_X2 * CNN_H / 2;     // dX2: Wt (128, 576)
constexpr int PK_W1B = PK_WTB + CNN_H * CNN_X2 / 2;    // dX1: W1 (64, 256)
constexpr int PK_TOTAL = PK_W1B + CNN_C1 * CNN_K1 / 2;  // 92,160
// the forward's share (PK_W0 .. PK_WTB): what the acting kernels pack
constexpr int PK_FWD = PK_WTB;                          // 47,104

// The forward tile's shared memory: W0's fragments (floats), then rows of
// the tile: splat scalars, two rendered patches (a window's conv1 output
// goes over the one conv0 has read), two patches' conv0 outputs (then h)
constexpr int TF_W0F = (PK_W1 - PK_W0) * 4;                    // 8,192
constexpr int TF_SP = 0;
constexpr int TF_XR = TF_SP + 12;
constexpr int TF_Y0 = TF_XR + 2 * CNN_K0;
constexpr int TF_ROWS = TF_Y0 + 2 * CNN_C0;                    // 268
constexpr int TF_SMEM = (TF_W0F + TF_ROWS * TM_S) * 4;         // 109,952
// ... of the backward tile: splat scalars, dzt, the window's four rendered
// patches, their conv0 outputs (then dz0), dz1
constexpr int TB_SP = 0;
constexpr int TB_DZT = TB_SP + 12;
constexpr int TB_XR = TB_DZT + CNN_H;
constexpr int TB_Y0 = TB_XR + CNN_K1;
constexpr int TB_DZ1 = TB_Y0 + CNN_K1;
constexpr int TB_ROWS = TB_DZ1 + CNN_C1;                       // 716
constexpr int TB_SMEM = TB_ROWS * TM_S * 4;                    // 206,208

// The bf16 arm: operand rows of TMB bf16 (144 bytes: ldmatrix's eight rows
// of 16 bytes hit eight bank groups), ROWB floats of shared memory each.
constexpr int TMB = 72;
constexpr int ROWB = TMB / 2;
// The packed bf16 fragments, in uint4s (a lane's B registers of two
// n-tiles of a k-tile of 16): B[k][n] of each product, as PK_*
constexpr int PKB_W0 = 0;
constexpr int PKB_W1 = PKB_W0 + CNN_K0 * CNN_C0 / 8;     // 512
constexpr int PKB_WT = PKB_W1 + CNN_K1 * CNN_C1 / 8;     // 2,560
constexpr int PKB_WTB = PKB_WT + CNN_X2 * CNN_H / 8;     // 11,776
constexpr int PKB_W1B = PKB_WTB + CNN_H * CNN_X2 / 8;    // 20,992
constexpr int PKB_TOTAL = PKB_W1B + CNN_C1 * CNN_K1 / 8;  // 23,040
constexpr int PKB_FWD = PKB_WTB;                          // 11,776
// The bf16 forward tile, in floats: W0's and W1's fragments, then the
// splat scalars (fp32 rows), two rendered patches and two patches' conv0
// outputs (bf16 rows), the window's conv1 output (fp32 rows for the X2
// copy, bf16 rows for the trunk); h (128 fp32 rows) goes over y0 and y1
constexpr int TFB_WF = PKB_WT * 4;                             // 10,240
constexpr int TFB_SP = 0;
constexpr int TFB_XR = TFB_SP + 12 * TM_S;
constexpr int TFB_Y0 = TFB_XR + 2 * CNN_K0 * ROWB;
constexpr int TFB_Y1 = TFB_Y0 + 2 * CNN_C0 * ROWB;
constexpr int TFB_Y1B = TFB_Y1 + CNN_C1 * TM_S;
constexpr int TFB_ROWS = TFB_Y1B + CNN_C1 * ROWB;              // 16,992
constexpr int TFB_H = TFB_Y0;
constexpr int TFB_SMEM = (TFB_WF + TFB_ROWS) * 4;              // 108,928
static_assert(TFB_H + CNN_H * TM_S <= TFB_Y1B, "h over y0 and y1");
// ... and backward tile: splat scalars, dzt, the window's four rendered
// patches, their conv0 outputs (then dz0), dz1 (bf16 rows), the row sums of
// dz1 ([4][64]) and of dz0 ([2][256])
constexpr int TBB_SP = 0;
constexpr int TBB_DZT = TBB_SP + 12 * TM_S;
constexpr int TBB_XR = TBB_DZT + CNN_H * ROWB;
constexpr int TBB_Y0 = TBB_XR + CNN_K1 * ROWB;
constexpr int TBB_DZ1 = TBB_Y0 + CNN_K1 * ROWB;
constexpr int TBB_RS = TBB_DZ1 + CNN_C1 * ROWB;
constexpr int TBB_SMEM = (TBB_RS + 4 * CNN_C1 + 2 * CNN_K1) * 4;  // 107,904
// the bf16 backward's blocks an SM (its launch bounds): K10 launches
// BWD_BLOCKS_B16 = 132 x two; K7 launches one block a product row (128 at
// its path's shape), so its library defines DRONE_TBB_PER_SM 1 and the
// kernel keeps the registers two blocks would not leave it
#ifndef DRONE_TBB_PER_SM
#define DRONE_TBB_PER_SM 2
#endif
constexpr int TBB_PER_SM = DRONE_TBB_PER_SM;

// The tower forward's shared bytes of an arm (the wrapper's count).
__host__ __device__ constexpr int tf_smem(bool bf16) {
  return bf16 ? TFB_SMEM : TF_SMEM;
}
__host__ __device__ constexpr int tb_smem(bool bf16) {
  return bf16 ? TBB_SMEM : TB_SMEM;
}

// Fragment loads from rows of a tile ([row][sample], stride TM_S), split
// (BF16: rounded).
// An A fragment with M = samples m0.. and K = rows k0..
template <bool BF16 = false>
__device__ __forceinline__ void frag_a_rows(const float* X, int k0, int m0,
                                            uint32_t (&ab)[4],
                                            uint32_t (&as)[4]) {
  const int lane = threadIdx.x & 31;
  const float* p = X + (k0 + (lane & 3)) * TM_S + m0 + (lane >> 2);
  split_op<BF16>(p[0], ab[0], as[0]);
  split_op<BF16>(p[8], ab[1], as[1]);
  split_op<BF16>(p[4 * TM_S], ab[2], as[2]);
  split_op<BF16>(p[4 * TM_S + 8], ab[3], as[3]);
}

// An A fragment with M = rows m0.. and K = samples k0..
__device__ __forceinline__ void frag_a_samples(const float* X, int m0, int k0,
                                               uint32_t (&ab)[4],
                                               uint32_t (&as)[4]) {
  const int lane = threadIdx.x & 31;
  const float* p = X + (m0 + (lane >> 2)) * TM_S + k0 + (lane & 3);
  split_tf32(p[0], ab[0], as[0]);
  split_tf32(p[8 * TM_S], ab[1], as[1]);
  split_tf32(p[4], ab[2], as[2]);
  split_tf32(p[8 * TM_S + 4], ab[3], as[3]);
}

// A B fragment with K = samples k0.. and N = rows n0..
__device__ __forceinline__ void frag_b_samples(const float* X, int n0, int k0,
                                               uint32_t (&bb)[2],
                                               uint32_t (&bs)[2]) {
  const int lane = threadIdx.x & 31;
  const float* p = X + (n0 + (lane >> 2)) * TM_S + k0 + (lane & 3);
  split_tf32(p[0], bb[0], bs[0]);
  split_tf32(p[4], bb[1], bs[1]);
}

// A packed fragment: from L2 and L1 (__ldg), or from shared memory (SB).
template <bool SB>
__device__ __forceinline__ float4 ld_frag(const float4* p) {
  if constexpr (SB)
    return *p;
  else
    return __ldg(p);
}

// acc[i][j] (samples m0 + 16 i .., n-tile nt0 + j) += sum over the K rows
// of X of X[k][sample] B[kt0 * 8 + k][n], B packed (NT n-tiles a k-tile),
// in device memory or, with SB, in shared memory. The weights of the next
// PF k-steps load while one multiplies (from L2; PF = 2 where a kernel has
// the registers). K is a multiple of 8 PF. BF16: one product a k-step.
template <int PF, bool SB = false, bool BF16 = false, int MI, int NI>
__device__ __forceinline__ void mma_rows_packed(const float* X, int K, int m0,
                                                const float4* __restrict__ B,
                                                int NT, int kt0, int nt0,
                                                float (&acc)[MI][NI][4]) {
  const float4* bp = B + ((size_t)kt0 * NT + nt0) * 32 + (threadIdx.x & 31);
  float4 w[PF][NI];
#pragma unroll
  for (int p = 0; p < PF; ++p)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      w[p][j] = ld_frag<SB>(bp + (size_t)p * NT * 32 + j * 32);
#pragma unroll 2
  for (int k = 0; k < K; k += 8 * PF) {
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int kk = k + 8 * p;
      uint32_t bb[NI][2], bs[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        bb[j][0] = __float_as_uint(w[p][j].x);
        bb[j][1] = __float_as_uint(w[p][j].y);
        bs[j][0] = __float_as_uint(w[p][j].z);
        bs[j][1] = __float_as_uint(w[p][j].w);
      }
      if (kk + 8 * PF < K) {
        const float4* nx = bp + (size_t)(kk / 8 + PF) * NT * 32;
#pragma unroll
        for (int j = 0; j < NI; ++j) w[p][j] = ld_frag<SB>(nx + j * 32);
      }
      uint32_t ab[MI][4], as[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        frag_a_rows<BF16>(X, kk, m0 + 16 * i, ab[i], as[i]);
      mma_op<BF16>(acc, ab, as, bb, bs);
    }
  }
}

// out rows = relu(acc + b) from a warp tile's accumulators: samples m0 +
// 16 i .., rows (n-tile nt0 + j) * 8 ..
template <int MI, int NI>
__device__ __forceinline__ void store_relu(const float (&acc)[MI][NI][4],
                                           int m0, int nt0,
                                           const float* __restrict__ bias,
                                           float* out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int n = (nt0 + j) * 8 + 2 * t;
    const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = m0 + 16 * i + g;
      out[n * TM_S + m] = fmaxf(acc[i][j][0] + b0, 0.0f);
      out[(n + 1) * TM_S + m] = fmaxf(acc[i][j][1] + b1, 0.0f);
      out[n * TM_S + m + 8] = fmaxf(acc[i][j][2] + b0, 0.0f);
      out[(n + 1) * TM_S + m + 8] = fmaxf(acc[i][j][3] + b1, 0.0f);
    }
  }
}

// out rows (64) = relu(X W^T + b) over the tile: X K rows, W packed (8
// n-tiles; in shared memory with SB). Warp w takes samples 16 (w % 4) ..
// and columns 32 (w / 4) ..
template <int PF, bool SB = false>
__device__ __forceinline__ void conv_mma(const float* X, int K,
                                         const float4* __restrict__ B,
                                         const float* __restrict__ bias,
                                         float* out) {
  const int w = threadIdx.x >> 5;
  const int m0 = 16 * CMI * (w % CMW), nt0 = CNI * (w / CMW);
  float acc[CMI][CNI][4];
  zero_frags(acc);
  mma_rows_packed<PF, SB>(X, K, m0, B, 8, 0, nt0, acc);
  store_relu(acc, m0, nt0, bias, out);
}

// ---- the bf16 arm's products ------------------------------------------

// The bf16 row value of relu(y): a positive y that rounds to bf16 zero is
// stored as -0, so the stored bits are nonzero exactly where y > 0 (the
// fp32 value's relu mask) and the operand is zero all the same.
__device__ __forceinline__ uint16_t relu_bits(float y) {
  if (!(y > 0.0f)) return 0;
  const uint16_t b = bf16_bits(y);
  return b ? b : (uint16_t)0x8000u;
}

// out bf16 rows (TMB apart) = relu(acc + b) from a warp tile's
// accumulators (store_relu's layout), with relu_bits' mask.
template <int MI, int NI>
__device__ __forceinline__ void store_relu_b16(const float (&acc)[MI][NI][4],
                                               int m0, int nt0,
                                               const float* __restrict__ bias,
                                               uint16_t* out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int n = (nt0 + j) * 8 + 2 * t;
    const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      uint16_t* o = out + n * TMB + m0 + 16 * i + g;
      o[0] = relu_bits(acc[i][j][0] + b0);
      o[TMB] = relu_bits(acc[i][j][1] + b1);
      o[8] = relu_bits(acc[i][j][2] + b0);
      o[TMB + 8] = relu_bits(acc[i][j][3] + b1);
    }
  }
}

// store_relu into fp32 rows (out, TM_S apart) and the same values rounded
// into bf16 rows (outb, TMB apart).
template <int MI, int NI>
__device__ __forceinline__ void store_relu_both(const float (&acc)[MI][NI][4],
                                                int m0, int nt0,
                                                const float* __restrict__ bias,
                                                float* out, uint16_t* outb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int n = (nt0 + j) * 8 + 2 * t;
    const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int m = m0 + 16 * i + g;
      const float v[4] = {fmaxf(acc[i][j][0] + b0, 0.0f),
                          fmaxf(acc[i][j][1] + b1, 0.0f),
                          fmaxf(acc[i][j][2] + b0, 0.0f),
                          fmaxf(acc[i][j][3] + b1, 0.0f)};
      out[n * TM_S + m] = v[0];
      out[(n + 1) * TM_S + m] = v[1];
      out[n * TM_S + m + 8] = v[2];
      out[(n + 1) * TM_S + m + 8] = v[3];
      outb[n * TMB + m] = bf16_bits(v[0]);
      outb[(n + 1) * TMB + m] = bf16_bits(v[1]);
      outb[n * TMB + m + 8] = bf16_bits(v[2]);
      outb[(n + 1) * TMB + m + 8] = bf16_bits(v[3]);
    }
  }
}

// A packed bf16 fragment pair: from L2 and L1 (__ldg), or from shared
// memory (SB).
template <bool SB>
__device__ __forceinline__ uint4 ld_frag16(const uint4* p) {
  if constexpr (SB)
    return *p;
  else
    return __ldg(p);
}

// acc[i][j] (samples m0 + 16 i .., n-tile nt0 + j) += sum over the K bf16
// rows of X (TMB apart) of X[k][sample] B[kt0 * 16 + k][n], B packed by
// pack_tower_kernel<true> (NT n-tiles a k-tile of 16; in shared memory with
// SB), one m16n8k16 product a k-step; X's A fragments by ldmatrix.trans,
// the next PF k-steps' weights loading while one multiplies. nt0 and NI
// even, K a multiple of 16 PF.
template <int PF, bool SB, int MI, int NI>
__device__ __forceinline__ void mma_rows_b16(const uint16_t* X, int K, int m0,
                                             const uint4* __restrict__ B,
                                             int NT, int kt0, int nt0,
                                             float (&acc)[MI][NI][4]) {
  static_assert(NI % 2 == 0, "n-tiles in pairs");
  const int lane = threadIdx.x & 31;
  const uint4* bp = B + ((size_t)kt0 * (NT / 2) + nt0 / 2) * 32 + lane;
  // this lane's ldmatrix row: k (lane & 7) + 8 (lane >> 4) of samples 8
  // ((lane >> 3) & 1) ..
  const uint16_t* xp =
      X + ((lane & 7) + 8 * (lane >> 4)) * TMB + m0 + 8 * ((lane >> 3) & 1);
  uint4 w[PF][NI / 2];
#pragma unroll
  for (int p = 0; p < PF; ++p)
#pragma unroll
    for (int j = 0; j < NI / 2; ++j)
      w[p][j] = ld_frag16<SB>(bp + (size_t)p * (NT / 2) * 32 + j * 32);
#pragma unroll 2
  for (int k = 0; k < K; k += 16 * PF) {
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int kk = k + 16 * p;
      uint32_t bb[NI][2];
#pragma unroll
      for (int j = 0; j < NI / 2; ++j) {
        bb[2 * j][0] = w[p][j].x;
        bb[2 * j][1] = w[p][j].y;
        bb[2 * j + 1][0] = w[p][j].z;
        bb[2 * j + 1][1] = w[p][j].w;
      }
      if (kk + 16 * PF < K) {
        const uint4* nx = bp + (size_t)(kk / 16 + PF) * (NT / 2) * 32;
#pragma unroll
        for (int j = 0; j < NI / 2; ++j) w[p][j] = ld_frag16<SB>(nx + j * 32);
      }
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldsm_x4_t(a[i], xp + kk * TMB + 16 * i);
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], bb[j]);
    }
  }
}

// acc[i][j] (rows m0 + 16 i .. of A, rows n0 + 8 j .. of B) += sum over
// samples s0 .. s0 + 15 of A[m][s] B[n][s], both bf16 rows of samples
// (stride TMB): A's and B's fragments by ldmatrix. NI even.
template <int MI, int NI>
__device__ __forceinline__ void mma_samples_b16(const uint16_t* A, int m0,
                                                const uint16_t* B, int n0,
                                                int s0,
                                                float (&acc)[MI][NI][4]) {
  static_assert(NI % 2 == 0, "n-tiles in pairs");
  const int lane = threadIdx.x & 31, r = lane & 7, q = lane >> 3;
  uint32_t a[MI][4], b[NI][2];
#pragma unroll
  for (int i = 0; i < MI; ++i)
    ldsm_x4(a[i], A + (m0 + 16 * i + r + 8 * (q & 1)) * TMB + s0 + 8 * (q >> 1));
#pragma unroll
  for (int j = 0; j < NI / 2; ++j) {
    uint32_t v[4];
    ldsm_x4(v, B + (n0 + 16 * j + r + 8 * (q >> 1)) * TMB + s0 + 8 * (q & 1));
    b[2 * j][0] = v[0];
    b[2 * j][1] = v[1];
    b[2 * j + 1][0] = v[2];
    b[2 * j + 1][1] = v[3];
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], b[j]);
}

// W0's fragments (BF16: W0's and W1's, pack_tower_kernel<true>'s) into the
// first TF_W0F (TFB_WF) floats of a forward tile's shared memory; a barrier
// must come before the block's first tower_forward. All threads.
template <bool BF16 = false>
__device__ __forceinline__ void tower_load_w0(float* sm,
                                              const float4* __restrict__ pk) {
  float4* w0 = reinterpret_cast<float4*>(sm);
  constexpr int n = BF16 ? PKB_WT - PKB_W0 : PK_W1 - PK_W0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    w0[i] = __ldg(pk + (BF16 ? PKB_W0 : PK_W0) + i);
}

// The rows of a forward tile's shared memory (TF_SP .. TF_ROWS; BF16:
// TFB_SP .. TFB_ROWS), after the staged fragments.
template <bool BF16 = false>
__device__ __forceinline__ float* tf_rows(float* sm) {
  return sm + (BF16 ? TFB_WF : TF_W0F);
}

// The tower's output h (128 fp32 rows of the tile) in a forward tile's
// shared memory.
template <bool BF16 = false>
__device__ __forceinline__ float* tf_h(float* sm) {
  return tf_rows<BF16>(sm) + (BF16 ? TFB_H : TF_Y0 * TM_S);
}

// The tower's forward over a tile of TM_L samples. sm: the tile's TF_SMEM
// bytes of shared memory, W0's fragments first (tower_load_w0); the caller
// put the splat scalars in rows TF_SP .. and passed a barrier. Patch j (36,
// four to a conv1 window) goes through conv0 into y0 buffer j % 2 while the
// block renders patch j + 1 into xr buffer (j + 1) % 2; after the patch's
// barrier conv1's sums in registers (warp w: samples 16 (w % 4) ..,
// columns 32 (w / 4) ..) add its 64 inputs. At a window's end its conv1
// output y1 goes over xr buffer 1, which conv0 has read; after a barrier
// the window's share of the trunk adds into sums in registers (warp w:
// samples 32 (w & 1) .., units 32 (w >> 1) ..) and on_window(q1, y1) sees
// y1 (X2 rows q1 * 64 ..); a barrier ends the window. Then h = relu(trunk +
// bt) into rows TF_Y0 .. TF_Y0 + 127; the caller needs a barrier before it
// reads h. All threads.
template <class OnWindow>
__device__ __forceinline__ void tower_fwd_tile(
    float* sm, const float* __restrict__ theta, const float4* __restrict__ pk,
    const float* __restrict__ grid, const OnWindow& on_window) {
  static_assert(CNN_WIN % 2 == 0, "a window ends on xr buffer 1");
  constexpr int NP = CNN_NQ1 * CNN_WIN;
  const float4* w0 = reinterpret_cast<const float4*>(sm);
  float* rows = tf_rows(sm);
  const float* sp = rows + TF_SP * TM_S;
  float* xr = rows + TF_XR * TM_S;
  float* y0 = rows + TF_Y0 * TM_S;
  const int w = threadIdx.x >> 5;
  const int mc = 16 * CMI * (w % CMW), ntc = CNI * (w / CMW);
  const int m0 = 32 * (w & 1), nt0 = 4 * (w >> 1);
  float c1[CMI][CNI][4], tacc[2][4][4];
  zero_frags(c1);
  zero_frags(tacc);
  render_patch<TM_L, TM_S>(window_patch(0, 0), sp, grid, xr);
  __syncthreads();
  for (int j = 0; j < NP; ++j) {
    const int q1 = j / CNN_WIN, k = j % CNN_WIN;
    float* xb = xr + (j & 1) * CNN_K0 * TM_S;
    float* yb = y0 + (j & 1) * CNN_C0 * TM_S;
    const int pn = window_patch((j + 1) / CNN_WIN, (j + 1) % CNN_WIN);
    float* xn = xr + ((j + 1) & 1) * CNN_K0 * TM_S;
    if (j + 1 < NP) render_patch<TM_L, TM_S>(pn, sp, grid, xn);
    conv_mma<1, true>(xb, CNN_K0, w0, theta + OFF_B0, yb);
    __syncthreads();
    mma_rows_packed<1, false>(yb, CNN_C0, mc, pk + PK_W1, CNN_C1 / 8,
                              k * (CNN_C0 / 8), ntc, c1);
    if (k == CNN_WIN - 1) {
      float* y1 = xb;
      store_relu(c1, mc, ntc, theta + OFF_B1, y1);
      zero_frags(c1);
      __syncthreads();
      mma_rows_packed<1, false>(y1, CNN_C1, m0, pk + PK_WT, CNN_H / 8,
                                q1 * (CNN_C1 / 8), nt0, tacc);
      on_window(q1, y1);
      __syncthreads();  // patch j + 2 renders over y1
    }
  }
  store_relu(tacc, m0, nt0, theta + OFF_BT, y0);
}

// The bf16 arm's forward over a tile: tower_fwd_tile's schedule (the next
// patch rendered beside this one's conv0, conv1's sums in registers, the
// trunk a window at a time) on bf16 rows and m16n8k16 products. sm: the
// tile's TFB_SMEM bytes, W0's and W1's fragments first
// (tower_load_w0<true>); pk packed by pack_tower_kernel<true>. Each
// window's conv1 output lands in its own fp32 rows (on_window(q1, y1) sees
// them) and bf16 rows (the trunk's operand), so no barrier ends a window;
// one barrier before h = relu(trunk + bt) goes over y0 and y1 (rows TFB_H
// .., fp32). 47 barriers a tile. All threads.
template <class OnWindow>
__device__ __forceinline__ void tower_fwd_b16(
    float* sm, const float* __restrict__ theta, const uint4* __restrict__ pk,
    const float* __restrict__ grid, const OnWindow& on_window) {
  constexpr int NP = CNN_NQ1 * CNN_WIN;
  const uint4* w0 = reinterpret_cast<const uint4*>(sm) + PKB_W0;
  const uint4* w1 = reinterpret_cast<const uint4*>(sm) + PKB_W1;
  float* rows = tf_rows<true>(sm);
  const float* sp = rows + TFB_SP;
  uint16_t* xr = reinterpret_cast<uint16_t*>(rows + TFB_XR);
  uint16_t* y0 = reinterpret_cast<uint16_t*>(rows + TFB_Y0);
  float* y1 = rows + TFB_Y1;
  uint16_t* y1b = reinterpret_cast<uint16_t*>(rows + TFB_Y1B);
  const int w = threadIdx.x >> 5;
  const int mc = 16 * CMI * (w % CMW), ntc = CNI * (w / CMW);
  const int m0 = 32 * (w & 1), nt0 = 4 * (w >> 1);
  float c1[CMI][CNI][4], tacc[2][4][4];
  zero_frags(c1);
  zero_frags(tacc);
  render_patch_b16(window_patch(0, 0), sp, grid, xr);
  __syncthreads();
  for (int j = 0; j < NP; ++j) {
    const int q1 = j / CNN_WIN, k = j % CNN_WIN;
    const uint16_t* xb = xr + (j & 1) * CNN_K0 * TMB;
    uint16_t* yb = y0 + (j & 1) * CNN_C0 * TMB;
    if (j + 1 < NP)
      render_patch_b16(window_patch((j + 1) / CNN_WIN, (j + 1) % CNN_WIN), sp,
                       grid, xr + ((j + 1) & 1) * CNN_K0 * TMB);
    {
      float acc[CMI][CNI][4];
      zero_frags(acc);
      mma_rows_b16<1, true>(xb, CNN_K0, mc, w0, CNN_C0 / 8, 0, ntc, acc);
      store_relu_b16(acc, mc, ntc, theta + OFF_B0, yb);
    }
    __syncthreads();
    mma_rows_b16<1, true>(yb, CNN_C0, mc, w1, CNN_C1 / 8, k * (CNN_C0 / 16),
                          ntc, c1);
    if (k == CNN_WIN - 1) {
      store_relu_both(c1, mc, ntc, theta + OFF_B1, y1, y1b);
      zero_frags(c1);
      __syncthreads();
      mma_rows_b16<1, false>(y1b, CNN_C1, m0, pk + PKB_WT, CNN_H / 8,
                             q1 * (CNN_C1 / 16), nt0, tacc);
      on_window(q1, static_cast<const float*>(y1));
    }
  }
  __syncthreads();  // h goes over y0 and y1
  store_relu(tacc, m0, nt0, theta + OFF_BT, rows + TFB_H);
}

// The tower's forward over a tile, either arm: tower_fwd_tile, or with BF16
// tower_fwd_b16 (pk packed by pack_tower_kernel<BF16>; the caller's splat
// scalars at tf_rows<BF16>(sm), h at tf_h<BF16>(sm)).
template <bool BF16, class OnWindow>
__device__ __forceinline__ void tower_forward(
    float* sm, const float* __restrict__ theta, const float4* __restrict__ pk,
    const float* __restrict__ grid, const OnWindow& on_window) {
  if constexpr (BF16)
    tower_fwd_b16(sm, theta, reinterpret_cast<const uint4*>(pk), grid,
                  on_window);
  else
    tower_fwd_tile(sm, theta, pk, grid, on_window);
}

// A warp's sum of row r (TM_L samples) of a tile, the same bits in every
// lane (a butterfly: each step adds two equal pairs in either order).
__device__ __forceinline__ float row_sum(const float* row) {
  const int lane = threadIdx.x & 31;
  float v = row[lane] + row[lane + 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = v + __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A block's weight gradients of conv1 and conv0, in registers across its
// tiles: gW1 (64 x 256) as warp w's rows 32 (w & 1) .., columns 64 (w >>
// 1) ..; gW0 (64 x 64) as rows 32 (w & 1) .., columns 16 (w >> 1) ..; gb1
// of row 8 w + lane in lanes 0..7, conv0's row sums (4 patches x 64) of
// row 32 w + lane.
struct TowerGrads {
  float w1[2][8][4];
  float w0[2][2][4];
  float b1, b0;
};

// The tower's backward over a tile, after the caller put the splat
// scalars (rows TB_SP ..) and dzt (rows TB_DZT .., the loss gradient at the
// trunk's pre-activation) in shared memory and passed a barrier; x2 is the
// tile's conv1 output in device memory (x2[(q1 * 64 + o) * NL + sample]).
// Per window: re-render the four patches and re-run conv0; dz1 = (dzt Wt)
// masked by X2 > 0; gW1 += dz1 X1^T; dz0 = (dz1 W1) masked by Y0 > 0, over
// y0; gW0 += dz0 X0^T. Ends with a barrier. All threads.
__device__ __forceinline__ void tower_bwd_tile(
    float* sm, const float* __restrict__ theta, const float4* __restrict__ pk,
    const float* __restrict__ grid, const float* __restrict__ x2, int NL,
    TowerGrads& gr) {
  const float* sp = sm + TB_SP * TM_S;
  const float* dzt = sm + TB_DZT * TM_S;
  float* xr = sm + TB_XR * TM_S;
  float* y0 = sm + TB_Y0 * TM_S;
  float* dz1 = sm + TB_DZ1 * TM_S;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 32 * (w & 1), wq = w >> 1;
  for (int q1 = 0; q1 < CNN_NQ1; ++q1) {
    for (int k = 0; k < CNN_WIN; ++k)
      render_patch<TM_L, TM_S>(window_patch(q1, k), sp, grid,
                               xr + k * CNN_K0 * TM_S);
    __syncthreads();
    for (int k = 0; k < CNN_WIN; ++k)
      conv_mma<2, false>(xr + k * CNN_K0 * TM_S, CNN_K0, pk + PK_W0,
                               theta + OFF_B0, y0 + k * CNN_C0 * TM_S);
    {
      // dz1 = (dzt Wt[:, window]) * (X2 > 0)
      const int mc = 16 * CMI * (w % CMW), ntc = CNI * (w / CMW);
      float acc[CMI][CNI][4];
      zero_frags(acc);
      mma_rows_packed<2, false>(dzt, CNN_H, mc, pk + PK_WTB, CNN_X2 / 8, 0,
                                q1 * (CNN_C1 / 8) + ntc, acc);
#pragma unroll
      for (int j = 0; j < CNI; ++j) {
        const int n = (ntc + j) * 8 + 2 * t;
        const float* xa = x2 + (size_t)(q1 * CNN_C1 + n) * NL;
#pragma unroll
        for (int i = 0; i < CMI; ++i) {
          const int m = mc + 16 * i + g;
          dz1[n * TM_S + m] = acc[i][j][0] * (xa[m] > 0.0f ? 1.0f : 0.0f);
          dz1[(n + 1) * TM_S + m] =
              acc[i][j][1] * (xa[NL + m] > 0.0f ? 1.0f : 0.0f);
          dz1[n * TM_S + m + 8] = acc[i][j][2] * (xa[m + 8] > 0.0f ? 1.0f : 0.0f);
          dz1[(n + 1) * TM_S + m + 8] =
              acc[i][j][3] * (xa[NL + m + 8] > 0.0f ? 1.0f : 0.0f);
        }
      }
    }
    __syncthreads();
    // gW1 += dz1 X1^T (X1: the window's conv0 outputs), gb1 += sum dz1;
    // the window's sums in fresh accumulators, 32 columns at a time
    // (unrolled: gr is indexed by constants only, so it stays in registers)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float acc[2][4][4];
      zero_frags(acc);
#pragma unroll 2
      for (int s0 = 0; s0 < TM_L; s0 += 8) {
        uint32_t ab[2][4], as[2][4], bb[4][2], bs[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          frag_a_samples(dz1, m0 + 16 * i, s0, ab[i], as[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          frag_b_samples(y0, 64 * wq + 32 * hf + 8 * j, s0, bb[j], bs[j]);
        mma3(acc, ab, as, bb, bs);
      }
      fold(gr.w1, hf, acc);
    }
#pragma unroll 1
    for (int r = 0; r < 8; ++r) {
      const float v = row_sum(dz1 + (8 * w + r) * TM_S);
      if (lane == r) gr.b1 = gr.b1 + v;
    }
    __syncthreads();
    // dz0 = (dz1 W1) * (Y0 > 0), over y0 in place, 128 columns at a time
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float acc[2][4][4];
      zero_frags(acc);
      const int nt0 = hf * 16 + 4 * wq;
      mma_rows_packed<2, false>(dz1, CNN_C1, m0, pk + PK_W1B, CNN_K1 / 8, 0,
                                nt0, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = (nt0 + j) * 8 + 2 * t;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = m0 + 16 * i + g;
          float* y = y0 + n * TM_S + m;
          y[0] = acc[i][j][0] * (y[0] > 0.0f ? 1.0f : 0.0f);
          y[TM_S] = acc[i][j][1] * (y[TM_S] > 0.0f ? 1.0f : 0.0f);
          y[8] = acc[i][j][2] * (y[8] > 0.0f ? 1.0f : 0.0f);
          y[TM_S + 8] = acc[i][j][3] * (y[TM_S + 8] > 0.0f ? 1.0f : 0.0f);
        }
      }
    }
    __syncthreads();
    // gW0 += dz0 X0^T over the window's four patches (the window's sums in
    // fresh accumulators), conv0's row sums
    {
      float acc[2][2][4];
      zero_frags(acc);
#pragma unroll 1
      for (int k = 0; k < CNN_WIN; ++k) {
        const float* d = y0 + k * CNN_C0 * TM_S;
        const float* x = xr + k * CNN_K0 * TM_S;
#pragma unroll 2
        for (int s0 = 0; s0 < TM_L; s0 += 8) {
          uint32_t ab[2][4], as[2][4], bb[2][2], bs[2][2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            frag_a_samples(d, m0 + 16 * i, s0, ab[i], as[i]);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            frag_b_samples(x, 16 * wq + 8 * j, s0, bb[j], bs[j]);
          mma3(acc, ab, as, bb, bs);
        }
      }
      fold(gr.w0, 0, acc);
    }
#pragma unroll 1
    for (int r = 0; r < 32; ++r) {
      const float v = row_sum(y0 + (32 * w + r) * TM_S);
      if (lane == r) gr.b0 = gr.b0 + v;
    }
    __syncthreads();  // the next window renders over xr and y0
  }
}

// s summed over the 8 lanes of a warp that share lane & 3 (the fragment
// rows g), the same bits in every lane.
__device__ __forceinline__ float sum_over_g(float s) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) s = s + __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// The bf16 arm's backward over a tile: tower_bwd_tile's windows and
// products on bf16 rows and m16n8k16 products, after the caller put the
// splat scalars (rows TBB_SP .., fp32) and dzt (TBB_DZT .., bf16) in shared
// memory and passed a barrier. dz1's and dz0's epilogues store them
// rounded and add their fp32 values over the warp's samples into the row
// sums (TBB_RS), which the gradients' owners (TowerGrads) add after the
// next barrier; dz0's relu mask is conv0's stored bits (relu_bits). Ends
// with a barrier. All threads.
__device__ __forceinline__ void tower_bwd_b16(
    float* sm, const float* __restrict__ theta, const uint4* __restrict__ pk,
    const float* __restrict__ grid, const float* __restrict__ x2, int NL,
    TowerGrads& gr) {
  const float* sp = sm + TBB_SP;
  const uint16_t* dzt = reinterpret_cast<const uint16_t*>(sm + TBB_DZT);
  uint16_t* xr = reinterpret_cast<uint16_t*>(sm + TBB_XR);
  uint16_t* y0 = reinterpret_cast<uint16_t*>(sm + TBB_Y0);
  uint16_t* dz1 = reinterpret_cast<uint16_t*>(sm + TBB_DZ1);
  float* rs1 = sm + TBB_RS;        // [4 sample quarters][64 rows]
  float* rs0 = rs1 + 4 * CNN_C1;   // [2 sample halves][256 rows]
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 32 * (w & 1), wq = w >> 1;
  const int mc = 16 * CMI * (w % CMW), ntc = CNI * (w / CMW);
  for (int q1 = 0; q1 < CNN_NQ1; ++q1) {
    for (int k = 0; k < CNN_WIN; ++k)
      render_patch_b16(window_patch(q1, k), sp, grid, xr + k * CNN_K0 * TMB);
    __syncthreads();
    for (int k = 0; k < CNN_WIN; ++k) {
      float acc[CMI][CNI][4];
      zero_frags(acc);
      mma_rows_b16<2, false>(xr + k * CNN_K0 * TMB, CNN_K0, mc, pk + PKB_W0,
                             CNN_C0 / 8, 0, ntc, acc);
      store_relu_b16(acc, mc, ntc, theta + OFF_B0, y0 + k * CNN_C0 * TMB);
    }
    {
      // dz1 = (dzt Wt[:, window]) * (X2 > 0), its row sums
      float acc[CMI][CNI][4];
      zero_frags(acc);
      mma_rows_b16<2, false>(dzt, CNN_H, mc, pk + PKB_WTB, CNN_X2 / 8, 0,
                             q1 * (CNN_C1 / 8) + ntc, acc);
#pragma unroll
      for (int j = 0; j < CNI; ++j) {
        const int n = (ntc + j) * 8 + 2 * t, m = mc + g;
        const float* xa = x2 + (size_t)(q1 * CNN_C1 + n) * NL;
        const float v0 = acc[0][j][0] * (xa[m] > 0.0f ? 1.0f : 0.0f);
        const float v1 = acc[0][j][1] * (xa[NL + m] > 0.0f ? 1.0f : 0.0f);
        const float v2 = acc[0][j][2] * (xa[m + 8] > 0.0f ? 1.0f : 0.0f);
        const float v3 = acc[0][j][3] * (xa[NL + m + 8] > 0.0f ? 1.0f : 0.0f);
        uint16_t* d = dz1 + n * TMB + m;
        d[0] = bf16_bits(v0);
        d[TMB] = bf16_bits(v1);
        d[8] = bf16_bits(v2);
        d[TMB + 8] = bf16_bits(v3);
        const float s0 = sum_over_g(v0 + v2), s1 = sum_over_g(v1 + v3);
        if (g == 0) {
          rs1[(w % CMW) * CNN_C1 + n] = s0;
          rs1[(w % CMW) * CNN_C1 + n + 1] = s1;
        }
      }
    }
    __syncthreads();
    if (lane < 8) {
      const int r = 8 * w + lane;
      gr.b1 = gr.b1 + (((rs1[r] + rs1[CNN_C1 + r]) + rs1[2 * CNN_C1 + r]) +
                       rs1[3 * CNN_C1 + r]);
    }
    // gW1 += dz1 X1^T (X1: the window's conv0 outputs); the window's sums in
    // fresh accumulators, 16 columns at a time (faster than 32 at a time
    // in the registers gr leaves two blocks an SM)
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      float acc[2][2][4];
      zero_frags(acc);
#pragma unroll
      for (int s0 = 0; s0 < TM_L; s0 += 16)
        mma_samples_b16(dz1, m0, y0, 64 * wq + 16 * qq, s0, acc);
      fold(gr.w1, qq, acc);
    }
    __syncthreads();
    // dz0 = (dz1 W1) * (Y0 > 0), over y0 in place, 128 columns at a time;
    // its row sums
#pragma unroll 1
    for (int hf = 0; hf < 2; ++hf) {
      float acc[2][4][4];
      zero_frags(acc);
      const int nt0 = hf * 16 + 4 * wq;
      mma_rows_b16<2, false>(dz1, CNN_C1, m0, pk + PKB_W1B, CNN_K1 / 8, 0,
                             nt0, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = (nt0 + j) * 8 + 2 * t;
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          uint16_t* y = y0 + n * TMB + m0 + 16 * i + g;
          const float v0 = acc[i][j][0] * (y[0] ? 1.0f : 0.0f);
          const float v1 = acc[i][j][1] * (y[TMB] ? 1.0f : 0.0f);
          const float v2 = acc[i][j][2] * (y[8] ? 1.0f : 0.0f);
          const float v3 = acc[i][j][3] * (y[TMB + 8] ? 1.0f : 0.0f);
          y[0] = bf16_bits(v0);
          y[TMB] = bf16_bits(v1);
          y[8] = bf16_bits(v2);
          y[TMB + 8] = bf16_bits(v3);
          s0 = s0 + (v0 + v2);
          s1 = s1 + (v1 + v3);
        }
        s0 = sum_over_g(s0);
        s1 = sum_over_g(s1);
        if (g == 0) {
          rs0[(w & 1) * CNN_K1 + n] = s0;
          rs0[(w & 1) * CNN_K1 + n + 1] = s1;
        }
      }
    }
    __syncthreads();
    gr.b0 = gr.b0 + (rs0[32 * w + lane] + rs0[CNN_K1 + 32 * w + lane]);
    // gW0 += dz0 X0^T over the window's four patches (the window's sums in
    // fresh accumulators)
    {
      float acc[2][2][4];
      zero_frags(acc);
#pragma unroll 1
      for (int k = 0; k < CNN_WIN; ++k)
#pragma unroll
        for (int s0 = 0; s0 < TM_L; s0 += 16)
          mma_samples_b16(y0 + k * CNN_C0 * TMB, m0, xr + k * CNN_K0 * TMB,
                          16 * wq, s0, acc);
      fold(gr.w0, 0, acc);
    }
    __syncthreads();  // the next window renders over xr and y0
  }
}

// Block part of the tower's gradients, [gW0 gb0 gW1 gb1] (the flat
// buffer's first OFF_WT floats), from a block's TowerGrads. red: 256
// floats of shared memory no thread reads any more. All threads.
__device__ __forceinline__ void tower_grads_out(const TowerGrads& gr,
                                                float* red, float* part) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 32 * (w & 1), wq = w >> 1;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int o = m0 + 16 * i + g;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 64 * wq + 8 * j + 2 * t;
      float* p = part + OFF_W1 + o * CNN_K1 + c;
      p[0] = gr.w1[i][j][0];
      p[1] = gr.w1[i][j][1];
      p[8 * CNN_K1] = gr.w1[i][j][2];
      p[8 * CNN_K1 + 1] = gr.w1[i][j][3];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 16 * wq + 8 * j + 2 * t;
      float* p = part + OFF_W0 + o * CNN_K0 + c;
      p[0] = gr.w0[i][j][0];
      p[1] = gr.w0[i][j][1];
      p[8 * CNN_K0] = gr.w0[i][j][2];
      p[8 * CNN_K0 + 1] = gr.w0[i][j][3];
    }
  }
  if (lane < 8) part[OFF_B1 + 8 * w + lane] = gr.b1;
  red[threadIdx.x] = gr.b0;  // conv0 row k * 64 + c of each window
  __syncthreads();
  if (threadIdx.x < CNN_C0) {
    const int c = threadIdx.x;
    part[OFF_B0 + c] = ((red[c] + red[CNN_C0 + c]) + red[2 * CNN_C0 + c])
                       + red[3 * CNN_C0 + c];
  }
}

// The tower's backward over fixed tiles of TM_L samples (lanes ml0 .. of
// step tl), block b taking tiles b, b + G, ...; its gW0, gb0, gW1, gb1 go
// to the first OFF_WT floats of partial row row0 + b. BF16: the bf16 arm
// (tower_bwd_b16, TBB_SMEM bytes, pk packed by pack_tower_kernel<true>),
// TBB_PER_SM blocks an SM.
struct TowerBwdArgs {
  const float* obs;    // obs row 0, step 0, lane 0
  size_t obs_step;     // floats between steps
  int obs_row;         // floats between obs rows
  const int* perm;     // the minibatch's row blocks, or null: lanes as is
  int rbl;
  int t0;              // the first step's index
  const float* dzs;    // dzt (steps, 128, NL)
  const float* x2s;    // X2 (steps, 576, NL)
  const float* theta;
  const float4* pk;
  const float* grid;
  float* partial;
  int ptot, row0, NL, n_tiles;
};

template <bool BF16>
__global__ void __launch_bounds__(TM_THREADS, BF16 ? TBB_PER_SM : 1)
tower_bwd_kernel(TowerBwdArgs A) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sp = sm + TB_SP * TM_S;
  float* dzt = sm + TB_DZT * TM_S;
  const int tid = threadIdx.x, NL = A.NL, per_t = NL / TM_L;
  TowerGrads gr;
  zero_frags(gr.w1);
  zero_frags(gr.w0);
  gr.b1 = 0.0f;
  gr.b0 = 0.0f;
  for (int tau = blockIdx.x; tau < A.n_tiles; tau += gridDim.x) {
    const int tl = tau / per_t, ml0 = (tau % per_t) * TM_L;
    const int lane0 =
        A.perm ? A.perm[ml0 / A.rbl] * A.rbl + ml0 % A.rbl : ml0;
    const float* ob = A.obs + (size_t)(A.t0 + tl) * A.obs_step + lane0;
    const float* dzs = A.dzs + (size_t)tl * CNN_H * NL + ml0;
    __syncthreads();  // the last tile's readers are done
    if (tid < TM_L) {
      float o[OBS_DIM], s12[12];
#pragma unroll
      for (int k = 0; k < OBS_DIM; ++k) o[k] = ob[(size_t)k * A.obs_row + tid];
      splat12(o, s12);
#pragma unroll
      for (int k = 0; k < 12; ++k) sp[k * TM_S + tid] = s12[k];
    }
    if constexpr (BF16) {
      // dzt rounded once into its bf16 rows, two samples a thread
      uint32_t* dzb = reinterpret_cast<uint32_t*>(sm + TBB_DZT);
      for (int e = tid; e < CNN_H * TM_L / 2; e += blockDim.x) {
        const int u = e / (TM_L / 2), l = 2 * (e % (TM_L / 2));
        const float2 v =
            *reinterpret_cast<const float2*>(dzs + (size_t)u * NL + l);
        dzb[u * (TMB / 2) + l / 2] = bf16x2(v.x, v.y);
      }
    } else {
      for (int e = tid; e < CNN_H * TM_L; e += blockDim.x) {
        const int u = e / TM_L, l = e % TM_L;
        dzt[u * TM_S + l] = dzs[(size_t)u * NL + l];
      }
    }
    __syncthreads();
    const float* x2 = A.x2s + (size_t)tl * CNN_X2 * NL + ml0;
    if constexpr (BF16)
      tower_bwd_b16(sm, A.theta, reinterpret_cast<const uint4*>(A.pk), A.grid,
                    x2, NL, gr);
    else
      tower_bwd_tile(sm, A.theta, A.pk, A.grid, x2, NL, gr);
  }
  tower_grads_out(gr, sm, A.partial + (size_t)(A.row0 + blockIdx.x) * A.ptot);
}

// The packed (big, small) fragments of the tower's weights (PK_*), the
// first `count` float4s (PK_TOTAL, or the forward's PK_FWD): float4 i of a
// product's K x N matrix B is lane (i % 32) of tile (kt, nt) = (i /
// 32 / NT, i / 32 % NT): {big, big, small, small} of B[8 kt + t][8 nt + g]
// and B[8 kt + t + 4][8 nt + g], g = lane / 4, t = lane % 4.
// BF16: the bf16 arm's fragments of m16n8k16 (PKB_*), the first `count`
// uint4s (PKB_TOTAL or PKB_FWD): uint4 i of B is lane (i % 32) of k-tile kt
// (16 rows) and n-tile pair np = (i / 32 / (N / 16), i / 32 % (N / 16)):
// the bf16x2 pairs {B[k][n], B[k + 1][n]}, {B[k + 8][n], B[k + 9][n]} of
// n = 16 np + g, then of n + 8, k = 16 kt + 2 t (rounded to nearest even).
template <bool BF16>
__global__ void pack_tower_kernel(const float* __restrict__ theta,
                                  float4* __restrict__ pk, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  int base, N, off, sn, sk;  // B[k][n] = theta[off + n * sn + k * sk]
  if constexpr (BF16) {
    if (i < PKB_W1) {
      base = PKB_W0, N = CNN_C0, off = OFF_W0, sn = CNN_K0, sk = 1;
    } else if (i < PKB_WT) {
      base = PKB_W1, N = CNN_C1, off = OFF_W1, sn = CNN_K1, sk = 1;
    } else if (i < PKB_WTB) {
      base = PKB_WT, N = CNN_H, off = OFF_WT, sn = CNN_X2, sk = 1;
    } else if (i < PKB_W1B) {
      base = PKB_WTB, N = CNN_X2, off = OFF_WT, sn = 1, sk = CNN_X2;
    } else {
      base = PKB_W1B, N = CNN_K1, off = OFF_W1, sn = 1, sk = CNN_K1;
    }
    const int e = i - base, lane = e % 32, tile = e / 32;
    const int NP = N / 16, kt = tile / NP, np = tile % NP;
    const int n = 16 * np + lane / 4, k = 16 * kt + 2 * (lane % 4);
    const float* b = theta + off + n * sn + k * sk;
    const float* c = b + 8 * sn;  // n + 8
    uint4 v;
    v.x = bf16x2(b[0], b[sk]);
    v.y = bf16x2(b[8 * sk], b[9 * sk]);
    v.z = bf16x2(c[0], c[sk]);
    v.w = bf16x2(c[8 * sk], c[9 * sk]);
    reinterpret_cast<uint4*>(pk)[i] = v;
  } else {
    if (i < PK_W1) {
      base = PK_W0, N = CNN_C0, off = OFF_W0, sn = CNN_K0, sk = 1;
    } else if (i < PK_WT) {
      base = PK_W1, N = CNN_C1, off = OFF_W1, sn = CNN_K1, sk = 1;
    } else if (i < PK_WTB) {
      base = PK_WT, N = CNN_H, off = OFF_WT, sn = CNN_X2, sk = 1;
    } else if (i < PK_W1B) {
      base = PK_WTB, N = CNN_X2, off = OFF_WT, sn = 1, sk = CNN_X2;
    } else {
      base = PK_W1B, N = CNN_K1, off = OFF_W1, sn = 1, sk = CNN_K1;
    }
    const int e = i - base, lane = e % 32, tile = e / 32;
    const int NT = N / 8, kt = tile / NT, nt = tile % NT;
    const int n = 8 * nt + lane / 4, k = 8 * kt + lane % 4;
    uint32_t b0, s0, b1, s1;
    split_tf32(theta[off + n * sn + k * sk], b0, s0);
    split_tf32(theta[off + n * sn + (k + 4) * sk], b1, s1);
    pk[i] = make_float4(__uint_as_float(b0), __uint_as_float(b1),
                        __uint_as_float(s0), __uint_as_float(s1));
  }
}

}  // namespace drone
