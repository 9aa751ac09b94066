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
// (cnn_mma.cuh's layout). K2's bf16 arm has its own forms below (_b16):
// bf16 rows, m16n8k16.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"

namespace drone {

constexpr int TOWER_OBS_ROWS = 16;  // the obs padded to 2 k-tiles
constexpr int TOWER_CHUNK = 16;     // units of a fold chunk: 2 n-tiles

__host__ __device__ constexpr int act_up8(int x) { return (x + 7) & ~7; }
__host__ __device__ constexpr int act_up16(int x) { return (x + 15) & ~15; }

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
// latter; with the adds, 1.0-1.4e-6, at 2% of the time (PERF.md).
template <int NI>
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
      split_tf32(p[0], ab[i][0], as_[i][0]);
      split_tf32(p[8], ab[i][1], as_[i][1]);
      split_tf32(p[4 * as], ab[i][2], as_[i][2]);
      split_tf32(p[4 * as + 8], ab[i][3], as_[i][3]);
    }
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
// registers. IEEE adds a k-step, as warp_mma.
template <int NI>
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
      split_tf32(x[i][j][0], ab[i][0], as_[i][0]);
      split_tf32(x[i][j][2], ab[i][1], as_[i][1]);
      split_tf32(x[i][j][1], ab[i][2], as_[i][2]);
      split_tf32(x[i][j][3], ab[i][3], as_[i][3]);
    }
    float part[2][1][4];
    zero_frags(part);
    mma3(part, ab, as_, bb, bs);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][0][r] = acc[i][0][r] + part[i][0][r];
  }
}

// K2's bf16 arm (compute_dtype="bfloat16"): the warp's rows are bf16, at
// the fp32 arm's stride (as, in elements) and the same [unit][lane] order,
// each written once by the store that produces it; A fragments come by
// ldmatrix.trans (the rows are k-major); B = W^T by m16n8k16 bf16x2
// fragments, a uint2 a lane a 16 x 8 tile (B[k][n], B[k + 1][n] and
// B[k + 8][n], B[k + 9][n], k = 16 kt + 2t, n = 8 nt + g), tiles k-major.
// A layer's inputs are padded to 16 rows (K of m16n8k16) with zeros or
// finite values that meet zero weights.

// acc[i][j] += sum over the K rows (a multiple of 16) of X of X[k][lane]
// B[k][n], as warp_mma: each k-step of 16 in fresh accumulators, added to
// acc with IEEE adds (H10).
template <int NI>
__device__ __forceinline__ void warp_mma_b16(const uint16_t* X, int as, int K,
                                             const uint2* B, int NT, int nt0,
                                             int nv, float (&acc)[2][NI][4]) {
  const int lane = threadIdx.x & 31;
  // this lane's ldmatrix.trans row: k (lane & 7) + 8 (lane >> 4), lanes 8
  // ((lane >> 3) & 1) ..; m-tile i at + 16 i
  const uint16_t* xp =
      X + ((lane & 7) + 8 * (lane >> 4)) * as + 8 * ((lane >> 3) & 1);
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t b[NI][2];
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const uint2 f = j < nv ? B[((k0 >> 4) * NT + nt0 + j) * 32 + lane]
                             : make_uint2(0u, 0u);
      b[j][0] = f.x;
      b[j][1] = f.y;
    }
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) ldsm_x4_t(a[i], xp + k0 * as + 16 * i);
    float part[2][NI][4];
    zero_frags(part);
#pragma unroll
    for (int j = 0; j < NI; ++j)
      if (j < nv)
#pragma unroll
        for (int i = 0; i < 2; ++i) mma_bf16(part[i][j], a[i], b[j]);
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = acc[i][j][r] + part[i][j][r];
  }
}

// store_tanh into bf16 rows: Y rows = bf16(tanh(acc + b)).
template <int NI>
__device__ __forceinline__ void store_tanh_b16(const float (&acc)[2][NI][4],
                                               int nv, int nt0, int row0,
                                               const float* bias, uint16_t* Y,
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
          Y[(row0 + n - 8 * nt0) * as + m] =
              bf16_bits(tanhf(acc[i][j][r] + bias[n]));
        }
}

// acc[i][0] += X B over one k-tile of 16: X a chunk of two n-tiles of a
// layer's outputs still in the accumulators' layout (x[i][j]: lanes 16 i
// .., units 8 j + 2 t, + 1 at rows g and g + 8), which is m16n8k16's A
// fragment as two bf16x2 packs a register (units 2t, 2t + 1 of the first
// n-tile, then of the second; nv 1: the second is padding, zero); B that
// k-tile's fragment of one n-tile. An IEEE add, as warp_mma_b16.
__device__ __forceinline__ void regs_mma_b16(const float (&x)[2][2][4], int nv,
                                             const uint2* B,
                                             float (&acc)[2][1][4]) {
  const int lane = threadIdx.x & 31;
  const uint2 f = B[lane];
  const uint32_t b[2] = {f.x, f.y};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t a[4] = {
        bf16x2(x[i][0][0], x[i][0][1]), bf16x2(x[i][0][2], x[i][0][3]),
        nv > 1 ? bf16x2(x[i][1][0], x[i][1][1]) : 0u,
        nv > 1 ? bf16x2(x[i][1][2], x[i][1][3]) : 0u};
    float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(part, a, b);
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][0][r] = acc[i][0][r] + part[r];
  }
}

}  // namespace drone
