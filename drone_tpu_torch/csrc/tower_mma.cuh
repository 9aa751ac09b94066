// tower_mma.cuh — the MLP tower on the tensor cores as the lanes of a warp
// evaluate it together, one product per layer: K5 (acting.cu, the actor)
// and K2 (acting_traj.cu, the actor and the critic).
//
// A warp's activations are rows of the block's lanes in shared memory
// ([unit][lane], row stride lanes + 8, = 8 mod 32: a fragment's 32 reads
// fall in 32 banks). A product is mma.sync m16n8k8 in 3xTF32 (mma.cuh):
// M = the warp's 32 lanes (2 m-tiles), K = a layer's inputs padded to 8
// (the 13 obs to 16), N = its outputs padded to 8. Its B = W^T is packed in
// the order a warp reads its fragments: a float4 a lane a k x n tile, tiles
// k-major, lane 4 g + t of tile (kt, nt) holding big B[k][n], big B[k +
// 4][n], small B[k][n], small B[k + 4][n] with k = 8 kt + t, n = 8 nt + g
// (cnn_mma.cuh's layout); in K2's bf16 arm big is B rounded to bf16.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace drone {

constexpr int TOWER_OBS_ROWS = 16;  // the obs padded to 2 k-tiles
constexpr int TOWER_CHUNK = 16;     // units of a fold chunk: 2 n-tiles

__host__ __device__ constexpr int act_up8(int x) { return (x + 7) & ~7; }

// One layer of a tower: its packed fragments (float4 offset), its padded
// bias (float offset).
struct ALayer {
  int nin, nout, fo, bo;
};

// acc[i][j] (the warp's lanes 16 i .., n-tile nt0 + j, j < nv) += sum over
// the K rows of X of X[k][lane] B[k][n], B packed (NT n-tiles a k-tile). X
// is the warp's first column of a buffer's first row. Each k-step's three
// products sum in fresh accumulators, added to acc with IEEE adds: the
// tensor cores' own accumulation over the k-steps (not fp32's
// round-to-nearest) put the serving check's T = 3 states 2-3e-6 off the
// fp32 plain version at [64, 64] and [128, 128], over its atol at the
// latter; with the adds, 1.0-1.4e-6, at 2% of the time (PERF.md). With
// BF16 each k-step is the one product of the bf16-rounded operands (K2's
// bf16 arm; the weights packed rounded, their small halves unread).
template <int NI, bool BF16 = false>
__device__ __forceinline__ void warp_mma(const float* X, int as, int K,
                                         const float4* B, int NT, int nt0,
                                         int nv, float (&acc)[2][NI][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t bb[NI][2], bs[NI][2];
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const float4 f = j < nv ? B[((k0 >> 3) * NT + nt0 + j) * 32 + lane]
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      bb[j][0] = __float_as_uint(f.x);
      bb[j][1] = __float_as_uint(f.y);
      bs[j][0] = __float_as_uint(f.z);
      bs[j][1] = __float_as_uint(f.w);
    }
    uint32_t ab[2][4], as_[2][4];
    float part[2][NI][4];
    zero_frags(part);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float* p = X + (k0 + t) * as + 16 * i + g;
      split_op<BF16>(p[0], ab[i][0], as_[i][0]);
      split_op<BF16>(p[8], ab[i][1], as_[i][1]);
      split_op<BF16>(p[4 * as], ab[i][2], as_[i][2]);
      split_op<BF16>(p[4 * as + 8], ab[i][3], as_[i][3]);
    }
    if constexpr (!BF16) {
#pragma unroll
      for (int j = 0; j < NI; ++j)
        if (j < nv)
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_tf32(part[i][j], as_[i], bb[j]);
#pragma unroll
      for (int j = 0; j < NI; ++j)
        if (j < nv)
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_tf32(part[i][j], ab[i], bs[j]);
    }
#pragma unroll
    for (int j = 0; j < NI; ++j)
      if (j < nv)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_tf32(part[i][j], ab[i], bb[j]);
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = acc[i][j][r] + part[i][j][r];
  }
}

// Y rows = tanh(acc + b) for n-tiles nt0 .. nt0 + nv - 1 (row n - 8 nt0 +
// row0 of Y); padded units get tanh(0) = 0.
template <int NI>
__device__ __forceinline__ void store_tanh(const float (&acc)[2][NI][4],
                                           int nv, int nt0, int row0,
                                           const float* bias, float* Y,
                                           int as) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NI; ++j)
    if (j < nv)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 8 * (nt0 + j) + 2 * t + (r & 1);
          const int m = 16 * i + g + (r & 2 ? 8 : 0);
          Y[(row0 + n - 8 * nt0) * as + m] = tanhf(acc[i][j][r] + bias[n]);
        }
}

// acc = tanh(acc + b) in place for n-tiles nt0 .. nt0 + nv - 1: a chunk of
// a layer's outputs that stays in the registers (regs_mma).
template <int NI>
__device__ __forceinline__ void tanh_regs(float (&acc)[2][NI][4], int nv,
                                          int nt0, const float* bias) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NI; ++j)
    if (j < nv)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 8 * (nt0 + j) + 2 * t + (r & 1);
          acc[i][j][r] = tanhf(acc[i][j][r] + bias[n]);
        }
}

// acc[i][0] += X B over the NI k-tiles of X, with X a chunk of a layer's
// outputs still in the accumulators' layout (x[i][j]: lanes 16 i .., units
// 8 j + 2 t and 8 j + 2 t + 1 at rows g and g + 8), B one n-tile a k-tile.
// The accumulators of an m16n8 tile are an A fragment of an m16n8k8 one
// whose k-tile holds unit 2 t at k = t and unit 2 t + 1 at k = t + 4, so
// B is packed in that order ("pair" order: lane 4 g + t of k-tile kt holds
// B[8 kt + 2 t][n] and B[8 kt + 2 t + 1][n]) and X never leaves the
// registers. IEEE adds a k-step, as warp_mma; BF16 as there.
template <int NI, bool BF16 = false>
__device__ __forceinline__ void regs_mma(const float (&x)[2][NI][4], int nv,
                                         const float4* B,
                                         float (&acc)[2][1][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    if (j >= nv) continue;
    const float4 f = B[j * 32 + lane];
    const uint32_t bb[1][2] = {{__float_as_uint(f.x), __float_as_uint(f.y)}};
    const uint32_t bs[1][2] = {{__float_as_uint(f.z), __float_as_uint(f.w)}};
    uint32_t ab[2][4], as_[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      split_op<BF16>(x[i][j][0], ab[i][0], as_[i][0]);
      split_op<BF16>(x[i][j][2], ab[i][1], as_[i][1]);
      split_op<BF16>(x[i][j][1], ab[i][2], as_[i][2]);
      split_op<BF16>(x[i][j][3], ab[i][3], as_[i][3]);
    }
    float part[2][1][4];
    zero_frags(part);
    mma_op<BF16>(part, ab, as_, bb, bs);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][0][r] = acc[i][0][r] + part[i][0][r];
  }
}

}  // namespace drone
