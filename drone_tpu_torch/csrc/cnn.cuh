// cnn.cuh — the patch-CNN policy (PatchCNNActorCritic) as CUDA device
// functions over a tile of lanes: its architecture and flat-buffer
// offsets, the render, the splat scalars and the heads, on the CUDA cores.
// The tower's products run on the tensor cores in 3xTF32 (cnn_mma.cuh's
// tower_fwd_tile and tower_bwd_tile; the bf16 arm's tower_fwd_b16 and
// tower_bwd_b16 on the bf16 tensor cores, render_patch_b16 rendering into
// its bf16 rows), in every kernel that runs the tower:
// the acting kernels (acting_cnn.cu: K11 and K9; the CNN arms of
// acting_lstm.cu: K8 and K6) and the updates (update_cnn.cu: K10;
// update_lstm.cu: K7's CNN arm).
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
// 2,304 floats), so a block owns a tile of lanes and keeps the tile's
// activations in shared memory as rows of the tile ([row][lane], rows S
// floats apart). The render is IEEE float32 with the reference's constants
// and expression order (H1): expf, never __expf.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"
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

// render_patch's values for a tile of 64 lanes (sp rows 72 floats apart)
// rounded into bf16 rows (72 bf16 apart; the bf16 arm's, cnn_mma.cuh TMB):
// a thread takes one channel, two lanes and 8 of the patch's 16 pixels, so
// it loads its splat scalars once and a warp reads each pixel's coordinates
// at once; a warp writes 128 contiguous bytes of a row a pixel. The values
// are render_patch's bits before rounding (the same expression).
__device__ __forceinline__ void render_patch_b16(int p, const float* sp,
                                                 const float* __restrict__ grid,
                                                 uint16_t* out) {
  constexpr int L = 64, S = 72, LP = L / 2, HALF = CNN_PP / 2;
  for (int e = threadIdx.x; e < CNN_K0 * L / (2 * HALF); e += blockDim.x) {
    const int lp = e % LP, c = (e / LP) % 4, s0 = HALF * (e / (4 * LP));
    const int l = 2 * lp;
    const float* su = sp + (3 * c) * S + l;
    const float u0[2] = {su[0], su[1]}, u1[2] = {su[S], su[S + 1]};
    const float amp[2] = {su[2 * S], su[2 * S + 1]};
    uint32_t* o = reinterpret_cast<uint32_t*>(out) + (c * CNN_PP + s0) *
                  (S / 2) + lp;
#pragma unroll
    for (int s = 0; s < HALF; ++s) {
      const float gx = __ldg(grid + p * CNN_PP + s0 + s);
      const float gy = __ldg(grid + CNN_RES * CNN_RES + p * CNN_PP + s0 + s);
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float a = gx - u0[q];
        const float b = gy - u1[q];
        const float d2 = a * a + b * b;
        v[q] = amp[q] * expf(-d2 * RENDER_INV);
      }
      o[s * (S / 2)] = bf16x2(v[0], v[1]);
    }
  }
}

// The action means and the value at lane l of h ([128][S]): dot(W, h) + b.
// BF16: W and h rounded to bf16 (mma.cuh op_value; each product exact).
template <bool BF16 = false>
__device__ __forceinline__ void cnn_heads(const float* h, int S, int l,
                                          const float* __restrict__ theta,
                                          float m[4], float& v) {
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int u = 0; u < CNN_H; ++u) {
    const float hv = op_value<BF16>(h[u * S + l]);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      acc[k] = __fmaf_rn(op_value<BF16>(__ldg(theta + OFF_HW + k * CNN_H + u)),
                         hv, acc[k]);
    acc[4] = __fmaf_rn(op_value<BF16>(__ldg(theta + OFF_VW + u)), hv, acc[4]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = acc[k] + __ldg(theta + OFF_HB + k);
  v = acc[4] + __ldg(theta + OFF_VB);
}

}  // namespace drone
