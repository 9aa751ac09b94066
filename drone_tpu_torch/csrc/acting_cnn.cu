// acting_cnn.cu — the patch-CNN acting kernels: CNN policy + env for T
// steps per lane. One kernel serves both:
//   K11 (serving): the policy mean (or, stochastic, K2's noise around it),
//     episode statistics only. Replaces drone_tpu/ops/pallas_acting_cnn.py
//     `_cnn_act_kernel` (driven by `cnn_act_rollout_pallas`).
//   K9 (training rollout): exploration noise, the value head and the 21
//     trajectory planes of K2. Replaces `_cnn_traj_kernel` (driven by
//     `traj_cnn_rollout_pallas`).
// Wrappers and plain versions: ops/cuda_acting_cnn.py.
//
// Design: a block of 256 threads owns a tile of 64 lanes. Per step the
// first 64 threads, one lane each, observe their lane (env.cuh's Carry
// stays in registers for the whole loop, as in K5 and K2), store the obs
// planes and its 12 splat scalars; then the block runs the tower's forward
// on the tensor cores in 3xTF32, cnn_mma.cuh's tower_fwd_tile (the one the
// updates K10 and K7 run: a patch's render overlapping the last patch's
// conv0, W0's fragments in shared memory, conv1 and the trunk summed in
// registers), h landing in the tile's rows; then the lane threads run the
// heads, the noise and log-prob (policy.cuh), the env step and the planes.
// The wrapper's call packs the forward's weights once (pack_tower_kernel,
// PK_W0 .. PK_WTB, 736 KB) on the launch's stream. Shared memory 109,952
// bytes (cnn_mma.cuh TF_SMEM), so two blocks share an SM and one block's
// render overlaps the other's products. A ragged last tile computes on
// zeros for its lanes past n and stores nothing for them.
//
// The bf16 arm (compute_dtype="bfloat16", the reference's bf16 operand
// arm of _cnn_traj_kernel and _cnn_act_kernel: cnn_forward's _dot32 rounds
// both operands of every product, the rendered pixels among them): the
// BF16 template parameter, K9's and K11's one instantiation
// (cnn_act_kernel<task, integrator, true>): pack_tower_kernel<true> packs
// the weights as bf16 fragments, the tower runs the bf16 design on the bf16
// tensor cores (cnn_mma.cuh tower_fwd_b16: operand rows stored once as
// bf16, m16n8k16 products, W0's and W1's fragments in shared memory;
// 108,928 bytes, two blocks an SM), and the heads round W and h (cnn.cuh
// cnn_heads<true>).
//
// What bounds it on an H100: ~369k multiply-adds of the tower per
// lane-step (conv0 147,456, conv1 147,456, trunk 73,728) at the 3xTF32
// rate (165 TFLOP/s of fp32-accurate products), and 2,304 expf, the heads'
// 640 multiply-adds and the env step on the fp32 cores; the planes are 84
// bytes a lane-step. The tower's operands split and its barriers hold the
// tensor cores below that rate (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "cnn_mma.cuh"
#include "env.cuh"

namespace drone {

struct CnnIO {
  const float* theta;  // flat parameters
  const float4* pk;    // the forward's packed fragments (cnn_mma.cuh PK_FWD)
  const float* grid;   // gx, gy: (2, 576)
  float* traj;         // (T, 21, n), or null when serving
  int T, stochastic;
};

template <int TASK, int INTEG, bool BF16>
__global__ void __launch_bounds__(TM_THREADS, 2)
cnn_act_kernel(const float* __restrict__ pf, const int* __restrict__ pi,
               Planes pl, CnnIO io) {
  constexpr int L = TM_L, S = TM_S;
  extern __shared__ float4 smem4[];
  __shared__ EnvP P;
  float* sm = reinterpret_cast<float*>(smem4);
  float* sp = tf_rows<BF16>(sm) + TF_SP * S;  // TFB_SP too
  const float* h = tf_h<BF16>(sm);             // the tower's output
  const int n = pl.n;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * L + tid;
  tower_load_w0<BF16>(sm, io.pk);
  load_params(pf, pi, P);  // ends with a barrier

  const bool lane_thread = tid < L && i < n;
  Carry cr;
  if (lane_thread) cr = read_carry(pl, i);
  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float ls[4], stdv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ls[k] = io.theta[OFF_LS + k];
    stdv[k] = expf(ls[k]);
  }

  for (int t = 0; t < io.T; ++t) {
    float* out = io.traj ? io.traj + (size_t)t * N_TRAJ * n + i : nullptr;
    if (tid < L) {
      float o[OBS_DIM];
      if (lane_thread) {
        observe(cr, o);
      } else {
#pragma unroll
        for (int k = 0; k < OBS_DIM; ++k) o[k] = 0.0f;
      }
      if (out && lane_thread) {
#pragma unroll
        for (int k = 0; k < OBS_DIM; ++k) out[(size_t)k * n] = o[k];
      }
      float s12[12];
      splat12(o, s12);
#pragma unroll
      for (int k = 0; k < 12; ++k) sp[k * S + tid] = s12[k];
    }
    __syncthreads();

    tower_forward<BF16>(sm, io.theta, io.pk, io.grid,
                        [](int, const float*) {});
    __syncthreads();

    if (lane_thread) {
      float m[4], v, a[4];
      cnn_heads<BF16>(h, S, tid, io.theta, m, v);
      if (out) {
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (io.stochastic) gauss4(cr.k0, cr.k1, cr.rc, cr.stp, z);
        float logp;
        sample_logp(m, z, ls, stdv, io.stochastic != 0, a, logp);
#pragma unroll
        for (int k = 0; k < 4; ++k) out[(size_t)(TP_ACT0 + k) * n] = a[k];
        out[(size_t)TP_LOGP * n] = logp;
        out[(size_t)TP_VAL * n] = v;
      } else if (io.stochastic) {
        float z[4], logp;
        gauss4(cr.k0, cr.k1, cr.rc, cr.stp, z);
        sample_logp(m, z, ls, stdv, true, a, logp);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) a[k] = m[k];
      }
      float r, epret2;
      bool done;
      int step2;
      env_step<TASK, INTEG>(cr, a[0], a[1], a[2], a[3], P, r, done, epret2,
                            step2);
      if (out) {
        out[(size_t)TP_REW * n] = r;
        out[(size_t)TP_DONE * n] = done ? 1.0f : 0.0f;
      }
      accumulate(acc, r, done, epret2, step2);
    }
    // the next step's first writes (sp) are read only after its barrier,
    // and h is rewritten only after one more
  }
  if (lane_thread) write_back(pl, i, cr, acc);
}

template <int TASK, int INTEG, bool BF16>
cudaError_t launch(const float* pf, const int* pi, const Planes& pl,
                   const CnnIO& io, float4* pk, cudaStream_t stream) {
  constexpr int smem = tf_smem(BF16), count = BF16 ? PKB_FWD : PK_FWD;
  cudaError_t err = cudaFuncSetAttribute(
      cnn_act_kernel<TASK, INTEG, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pack_tower_kernel<BF16><<<(count + 255) / 256, 256, 0, stream>>>(
      io.theta, pk, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cnn_act_kernel<TASK, INTEG, BF16>
      <<<(pl.n + TM_L - 1) / TM_L, TM_THREADS, smem, stream>>>(pf, pi, pl,
                                                                io);
  return cudaGetLastError();
}

}  // namespace drone

// C interface (ctypes). pf/pi: device env params; fs..stats: the state and
// statistic planes of rollout.cu; theta: the flat parameters (95,113); pk:
// room for the forward's packed fragments (PK_FWD float4s; the bf16 arm's
// PKB_FWD uint4s), written here on the stream before the kernel reads them;
// grid: the pixel coordinates (2, 576); traj: the (T, 21, n) planes to
// train (K9), or null to serve (K11); smem: the block's shared bytes as the
// wrapper counts them (refused unless tf_smem of the arm); bf16: 1 for the
// bf16 operand arm, 0 for 3xTF32.
extern "C" int drone_cnn_act_rollout(
    const float* pf, const int* pi, const float* fs, const uint32_t* us,
    const int* st, float* ofs, uint32_t* ous, int* ost, float* stats,
    const float* theta, float* pk, const float* grid, float* traj,
    int stochastic, int smem, int bf16, int n, int T, int task,
    int integrator, void* stream) {
  using namespace drone;
  if (n <= 0 || T < 0 || pk == nullptr || bf16 < 0 || bf16 > 1 ||
      smem != tf_smem(bf16 != 0))
    return (int)cudaErrorInvalidValue;
  float4* pk4 = reinterpret_cast<float4*>(pk);
  const CnnIO io{theta, pk4, grid, traj, T, stochastic};
  const Planes pl{fs, us, st, ofs, ous, ost, stats, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DRONE_CNN_CASE(TK, IG)                                         \
  if (task == TK && integrator == IG)                                  \
    return bf16 ? (int)launch<TK, IG, true>(pf, pi, pl, io, pk4, s)    \
                : (int)launch<TK, IG, false>(pf, pi, pl, io, pk4, s);
  DRONE_CNN_CASE(TASK_HOVER, INTEG_EULER)
  DRONE_CNN_CASE(TASK_HOVER, INTEG_RK4)
  DRONE_CNN_CASE(TASK_WAYPOINT, INTEG_EULER)
  DRONE_CNN_CASE(TASK_WAYPOINT, INTEG_RK4)
  DRONE_CNN_CASE(TASK_RACING, INTEG_EULER)
  DRONE_CNN_CASE(TASK_RACING, INTEG_RK4)
#undef DRONE_CNN_CASE
  return (int)cudaErrorInvalidValue;
}
