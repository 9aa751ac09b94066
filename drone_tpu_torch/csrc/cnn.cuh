// cnn.cuh — the patch-CNN policy (PatchCNNActorCritic) as CUDA device
// functions over a tile of lanes, shared by the CNN acting kernels
// (acting_cnn.cu: K11 and K9, and the CNN arms of acting_lstm.cu: K8 and
// K6). The CNN updates (K10 and K7's CNN arm) take its render, splat
// scalars and heads, and run the tower's products on the tensor cores
// (cnn_mma.cuh).
//
// Ports drone_tpu/ops/pallas_acting_cnn.py: `splat_planes` (12 splat scalars
// per lane from its observation), `render_patch` (one conv0 input block of
// the 24x24x4 splat image, re-rendered, never stored), `cnn_encode` (conv0
// 4x4/4 -> 64, conv1 2x2/2 -> 64 over the windows of `conv1_patches`, trunk
// 576 -> 128, relu after each) and the heads of `cnn_forward`.
//
// The kernels are specialized to the one architecture the reference's
// trainer builds (PatchCNNActorCritic() defaults); the wrappers refuse any
// other (ops/cuda_acting_cnn.py check_envelope).
//
// One lane's activations do not fit a thread (conv0 alone is 36 x 64 =
// 2,304 floats), so a block owns a tile of L lanes and keeps the tile's
// activations in shared memory as rows of the tile ([row][lane], rows S
// floats apart). The forward streams window by window: each conv1 window
// reads exactly four conv0 patches, so per window the block renders a
// patch (64 rows), applies conv0 (64 rows), four times, applies conv1 to
// the 256 rows, and adds the window's 64 columns of the trunk into 128 x L
// sums that stay in registers. Only one window's conv0 output is ever live.
//
// Each product is register-tiled: a thread owns RM output rows x 4 lanes
// and per input row reads its RM weights as vectors and 4 activations.
// The weights (~370 KB, the trunk's 288 KB of them) do not fit shared
// memory; they stream from L2, read as broadcasts by the threads that
// share their rows. The products read the transposed copies W^T that the
// wrapper makes (a thread's rows contiguous).
//
// Sums use explicit fmaf and run in another order than the reference's
// matmuls (the trunk's 576-long dot as 9 windows of 64): the kernels are
// held to their plain versions at a tolerance. The render is IEEE float32
// with the reference's constants and expression order (H1): expf, never
// __expf.
#pragma once

#include <cuda_runtime.h>

#include "policy.cuh"

namespace drone {

// architecture (the reference's PatchCNNActorCritic defaults)
constexpr int CNN_RES = 24;
constexpr int CNN_PP = 16;            // pixels of a conv0 patch (4 x 4)
constexpr int CNN_G0 = 6;             // conv0 patches a side
constexpr int CNN_G1 = 3;             // conv1 windows a side
constexpr int CNN_NQ1 = 9;
constexpr int CNN_WIN = 4;            // conv0 patches of a window
constexpr int CNN_K0 = 64;            // conv0 inputs: channels x pixels
constexpr int CNN_C0 = 64;
constexpr int CNN_K1 = 256;           // conv1 inputs: WIN x C0
constexpr int CNN_C1 = 64;
constexpr int CNN_X2 = 576;           // trunk inputs: NQ1 x C1
constexpr int CNN_H = 128;
constexpr int CNN_THREADS = 256;

// the flat buffer (cnn_kernel_tensors order)
constexpr int OFF_W0 = 0;                                   // (C0, K0)
constexpr int OFF_B0 = OFF_W0 + CNN_C0 * CNN_K0;
constexpr int OFF_W1 = OFF_B0 + CNN_C0;                     // (C1, K1)
constexpr int OFF_B1 = OFF_W1 + CNN_C1 * CNN_K1;
constexpr int OFF_WT = OFF_B1 + CNN_C1;                     // (H, X2)
constexpr int OFF_BT = OFF_WT + CNN_H * CNN_X2;
constexpr int OFF_HW = OFF_BT + CNN_H;                      // (4, H)
constexpr int OFF_HB = OFF_HW + 4 * CNN_H;
constexpr int OFF_VW = OFF_HB + 4;                          // (1, H)
constexpr int OFF_VB = OFF_VW + CNN_H;
constexpr int OFF_LS = OFF_VB + 1;
constexpr int CNN_P = OFF_LS + 4;                           // 95,113
// the transposed copies: W0^T (K0, C0), W1^T (K1, C1), Wt^T (X2, H)
constexpr int T_W0 = 0;
constexpr int T_W1 = T_W0 + CNN_K0 * CNN_C0;
constexpr int T_WT = T_W1 + CNN_K1 * CNN_C1;                // + 73,728

// float32(1 / (2 * 0.18^2)), rounded from the double as the reference's
// jnp.float32(1.0 / (2.0 * _SIGMA * _SIGMA)) (0x4176E9E0)
constexpr float RENDER_INV = 15.432098388671875f;

// splat_planes for one lane: obs -> (u0, u1, amp) of the 4 channels, in
// sp[3 * c + 0..2].
__device__ __forceinline__ void splat12(const float o[OBS_DIM], float sp[12]) {
  const float w = o[3], x = o[4], y = o[5], z = o[6];
  const float r00 = 1.0f - 2.0f * (y * y + z * z), r01 = 2.0f * (x * y + w * z),
              r02 = 2.0f * (x * z - w * y);
  const float r10 = 2.0f * (x * y - w * z), r11 = 1.0f - 2.0f * (x * x + z * z),
              r12 = 2.0f * (y * z + w * x);
  const float r20 = 2.0f * (x * z + w * y), r21 = 2.0f * (y * z - w * x),
              r22 = 1.0f - 2.0f * (x * x + y * y);
  float v[3][3];  // the target offset and the velocity in the body frame,
                  // then omega
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    const float v0 = o[b ? 7 : 0], v1 = o[b ? 8 : 1], v2 = o[b ? 9 : 2];
    v[b][0] = r00 * v0 + r01 * v1 + r02 * v2;
    v[b][1] = r10 * v0 + r11 * v1 + r12 * v2;
    v[b][2] = r20 * v0 + r21 * v1 + r22 * v2;
  }
  v[2][0] = o[10];
  v[2][1] = o[11];
  v[2][2] = o[12];
  float u[3][2], d[3];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    d[b] = sqrtf(v[b][0] * v[b][0] + v[b][1] * v[b][1] + v[b][2] * v[b][2]);
    const float inv = 1.0f / (1.0f + d[b]);
    u[b][0] = v[b][0] * inv;
    u[b][1] = v[b][1] * inv;
  }
  sp[0] = u[0][0];
  sp[1] = u[0][1];
  sp[2] = 1.0f / (1.0f + d[0]);
  sp[3] = r02;
  sp[4] = r12;
  sp[5] = 0.5f + 0.5f * r22;
  sp[6] = u[1][0];
  sp[7] = u[1][1];
  sp[8] = d[1] / (1.0f + d[1]);
  sp[9] = u[2][0];
  sp[10] = u[2][1];
  sp[11] = d[2] / (1.0f + d[2]);
}

// The conv0 patch p of conv1 window q1, k its (di, dj) index.
__host__ __device__ __forceinline__ int window_patch(int q1, int k) {
  return ((q1 / CNN_G1) * 2 + k / 2) * CNN_G0 + (q1 % CNN_G1) * 2 + k % 2;
}

// render_patch: patch p's 64 input rows (channel-major: row c * 16 + s)
// for the tile's lanes, from the splat scalars sp ([12][S]) and the pixel
// coordinates grid (gx (576) then gy (576), patch-major). All threads.
template <int L, int S>
__device__ __forceinline__ void render_patch(int p, const float* sp,
                                             const float* __restrict__ grid,
                                             float* out) {
  for (int e = threadIdx.x; e < CNN_K0 * L; e += blockDim.x) {
    const int r = e / L, l = e % L;
    const int c = r / CNN_PP, s = r % CNN_PP;
    const float gx = __ldg(grid + p * CNN_PP + s);
    const float gy = __ldg(grid + CNN_RES * CNN_RES + p * CNN_PP + s);
    const float a = gx - sp[(3 * c) * S + l];
    const float b = gy - sp[(3 * c + 1) * S + l];
    const float d2 = a * a + b * b;
    out[r * S + l] = sp[(3 * c + 2) * S + l] * expf(-d2 * RENDER_INV);
  }
}

// This thread's place in a product over the tile: rows m0 .. m0 + RM - 1
// and lanes l0 .. l0 + 3 (L / 4 lane groups, the rest of the block over the
// rows: M = RM * blockDim / (L / 4)).
template <int L, int RM>
__device__ __forceinline__ void tile_of(int& m0, int& l0) {
  m0 = (threadIdx.x / (L / 4)) * RM;
  l0 = 4 * (threadIdx.x % (L / 4));
}

// acc[r][q] += sum_k A[k * lda + m0 + r] * in[k * S + l0 + q]: A in device
// memory (k-major: a thread's RM rows contiguous), `in` rows of the tile in
// shared memory.
template <int RM, int S>
__device__ __forceinline__ void mm_acc(const float* __restrict__ A, int lda,
                                       int K, const float* in, int m0, int l0,
                                       float (&acc)[RM][4]) {
  static_assert(RM == 2 || RM % 4 == 0, "RM is 2 or a multiple of 4");
  for (int k = 0; k < K; ++k) {
    float x[4];
    if constexpr (S % 4 == 0) {
      const float4 v = *reinterpret_cast<const float4*>(in + k * S + l0);
      x[0] = v.x;
      x[1] = v.y;
      x[2] = v.z;
      x[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = in[k * S + l0 + q];
    }
    float w[RM];
    const float* a = A + (size_t)k * lda + m0;
    if constexpr (RM == 2) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(a));
      w[0] = v.x;
      w[1] = v.y;
    } else {
#pragma unroll
      for (int j = 0; j < RM / 4; ++j) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(a) + j);
        w[4 * j] = v.x;
        w[4 * j + 1] = v.y;
        w[4 * j + 2] = v.z;
        w[4 * j + 3] = v.w;
      }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = __fmaf_rn(w[r], x[q], acc[r][q]);
  }
}

template <int RM>
__device__ __forceinline__ void zero_acc(float (&acc)[RM][4]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.0f;
}

// out rows m (64 of them, M = 64) = relu(sum_k W[m][k] in[k] + b[m]) for a
// conv layer: WT its transposed weights (K, 64), b its bias.
template <int L, int S>
__device__ __forceinline__ void conv_relu(const float* __restrict__ WT, int K,
                                          const float* __restrict__ b,
                                          const float* in, float* out) {
  constexpr int RM = 64 * (L / 4) / CNN_THREADS;
  int m0, l0;
  tile_of<L, RM>(m0, l0);
  float acc[RM][4];
  zero_acc(acc);
  mm_acc<RM, S>(WT, 64, K, in, m0, l0, acc);
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const float bias = __ldg(b + m0 + r);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[(m0 + r) * S + l0 + q] = fmaxf(acc[r][q] + bias, 0.0f);
  }
}

// The rows of the trunk's sums this thread owns.
template <int L>
constexpr int TRUNK_ROWS = CNN_H * (L / 4) / CNN_THREADS;

// One conv1 window of the encoder's forward, after the caller put the
// window's four conv0 outputs in y0 ([256][S]): y1 = conv1 (64 rows), then
// the trunk's sums += Wt[:, window] y1. The caller needs a barrier between
// conv1 and the trunk's read of y1 (done here) and after.
template <int L, int S>
__device__ __forceinline__ void window_conv1_trunk(
    int q1, const float* __restrict__ theta, const float* __restrict__ wt,
    const float* y0, float* y1, float (&tacc)[TRUNK_ROWS<L>][4]) {
  conv_relu<L, S>(wt + T_W1, CNN_K1, theta + OFF_B1, y0, y1);
  __syncthreads();
  constexpr int RT = TRUNK_ROWS<L>;
  int m0, l0;
  tile_of<L, RT>(m0, l0);
  mm_acc<RT, S>(wt + T_WT + q1 * CNN_C1 * CNN_H, CNN_H, CNN_C1, y1, m0, l0,
                tacc);
}

// Discards what cnn_encode_tile shows of each window.
struct NoWindowOut {
  __device__ void operator()(int, const float*) const {}
};

// h = relu(trunk sums + bt) into rows 0..127 of h ([128][S]).
template <int L, int S>
__device__ __forceinline__ void trunk_out(const float* __restrict__ theta,
                                          const float (&tacc)[TRUNK_ROWS<L>][4],
                                          float* h) {
  constexpr int RT = TRUNK_ROWS<L>;
  int m0, l0;
  tile_of<L, RT>(m0, l0);
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const float bias = __ldg(theta + OFF_BT + m0 + r);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      h[(m0 + r) * S + l0 + q] = fmaxf(tacc[r][q] + bias, 0.0f);
  }
}

// The encoder's forward over a tile of L lanes, after the caller put the
// splat scalars in sp ([12][S]) and passed a barrier: per conv1 window,
// each of its four conv0 patches rendered into xr ([64][S]) and put
// through conv0 into y0 ([256][S]), then conv1 into y1 ([64][S]) and the
// window's share of the trunk into sums held in registers;
// on_window(q1, y1) sees each window's conv1 output (the trunk's inputs
// q1 * 64 ..) before the barrier that ends the window. Then h = relu(trunk
// + bt) into rows 0..127 of h ([128][S], which may be y0); the caller
// needs a barrier before it reads h. All threads.
template <int L, int S, class OnWindow>
__device__ __forceinline__ void cnn_encode_tile(
    const float* sp, const float* __restrict__ theta,
    const float* __restrict__ wt, const float* __restrict__ grid, float* xr,
    float* y0, float* y1, float* h, const OnWindow& on_window) {
  float tacc[TRUNK_ROWS<L>][4];
  zero_acc(tacc);
  for (int q1 = 0; q1 < CNN_NQ1; ++q1) {
    for (int k = 0; k < CNN_WIN; ++k) {
      render_patch<L, S>(window_patch(q1, k), sp, grid, xr);
      __syncthreads();
      conv_relu<L, S>(wt + T_W0, CNN_K0, theta + OFF_B0, xr,
                      y0 + k * CNN_C0 * S);
      __syncthreads();
    }
    window_conv1_trunk<L, S>(q1, theta, wt, y0, y1, tacc);
    on_window(q1, y1);
    __syncthreads();  // conv1 and the next window's conv0 share y0
  }
  trunk_out<L, S>(theta, tacc, h);
}

// The action means and the value at lane l of h ([128][S]): dot(W, h) + b.
__device__ __forceinline__ void cnn_heads(const float* h, int S, int l,
                                          const float* __restrict__ theta,
                                          float m[4], float& v) {
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int u = 0; u < CNN_H; ++u) {
    const float hv = h[u * S + l];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[k] = __fmaf_rn(__ldg(theta + OFF_HW + k * CNN_H + u), hv, acc[k]);
    acc[4] = __fmaf_rn(__ldg(theta + OFF_VW + u), hv, acc[4]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = acc[k] + __ldg(theta + OFF_HB + k);
  v = acc[4] + __ldg(theta + OFF_VB);
}

}  // namespace drone
