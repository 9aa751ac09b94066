// acting.cu — the MLP acting megakernel: policy + env for T steps per lane.
//
// Replaces drone_tpu/ops/pallas_acting.py `_acting_kernel` (driven by
// `act_rollout_pallas`; evaluate()'s path). Wrapper and plain version:
// ops/cuda_acting.py.
//
// Design: one thread per lane, the env loop of rollout.cu (env.cuh) with
// the actor tower evaluated in the thread before each step: tanh hidden
// layers of any depth (up to MAX_HIDDEN layers, widths up to MAX_WIDTH)
// and a linear head of 4 action means. Deterministic mode acts with the
// mean; stochastic mode adds exp(log_std) * z with z from Box-Muller over
// the lane's threefry stream at NOISE_BLOCK0 + 2*step (_gauss4_planes).
//
// The tower and the Box-Muller draw are policy.cuh's (shared with K2,
// acting_traj.cu).
//
// What bounds it on an H100: the tower's multiply-adds on the fp32 cores
// (5,184 per lane-step for [64, 64], 13*64 + 64*64 + 64*4), plus one tanhf
// per hidden unit. The design:
//   - the weights and biases are staged once per block into shared memory
//     (21 KB for [64, 64]), each layer as W^T (in, out padded to 16) and a
//     padded bias. Every thread of a warp reads the same 16 bytes at once,
//     which shared memory serves as a broadcast;
//   - a layer is computed 16 outputs at a time in 16 register accumulators,
//     reading the input activations from the thread's own column of shared
//     memory ([unit][thread], conflict-free);
//   - the last hidden layer is folded into the 4 head accumulators chunk by
//     chunk, so its activations are never stored.
// Tensor-core (wgmma) towers are work for a later change.

#include <cuda_runtime.h>

#include <cstdint>

#include "env.cuh"
#include "policy.cuh"

namespace drone {

constexpr int ACT_THREADS = 128;

template <int TASK, int INTEG, bool STOCH>
__global__ void __launch_bounds__(ACT_THREADS)
act_kernel(const float* __restrict__ pf, const int* __restrict__ pi,
           Planes pl, Tower tw, const float4* __restrict__ weights, int T) {
  extern __shared__ float4 smem4[];
  __shared__ EnvP P;
  for (int k = threadIdx.x; k < tw.n_weights / 4; k += blockDim.x)
    smem4[k] = weights[k];
  load_params(pf, pi, P);  // ends with the barrier both copies need
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pl.n) return;  // no barrier follows

  const float* sw = reinterpret_cast<const float*>(smem4);
  const int B = blockDim.x;
  float* col_obs = reinterpret_cast<float*>(smem4) + tw.n_weights + threadIdx.x;
  float* col_a = col_obs + CHUNK * B;
  float* col_b = col_a + tw.maxw_p * B;

  Carry c = read_carry(pl, i);
  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < T; ++t) {
    float o[OBS_DIM];
    observe(c, o);
#pragma unroll
    for (int k = 0; k < OBS_DIM; ++k) col_obs[k * B] = o[k];
    float a[4];
    tower<4>(sw, tw, col_obs, col_a, col_b, B, a);
    if (STOCH) {
      float z[4];
      gauss4(c.k0, c.k1, c.rc, c.stp, z);
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = a[k] + tw.std[k] * z[k];
    }
    float r, epret2;
    bool done;
    int step2;
    env_step<TASK, INTEG>(c, a[0], a[1], a[2], a[3], P, r, done, epret2,
                          step2);
    accumulate(acc, r, done, epret2, step2);
  }
  write_back(pl, i, c, acc);
}

// Shared memory of one block: the weights and the activation columns.
inline size_t smem_bytes(const Tower& tw) {
  return sizeof(float) *
         ((size_t)tw.n_weights + (size_t)activation_floats(tw, ACT_THREADS));
}

template <int TASK, int INTEG, bool STOCH>
cudaError_t launch(const float* pf, const int* pi, const Planes& pl,
                   const Tower& tw, const float4* weights, int T,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(tw);
  cudaError_t err = cudaFuncSetAttribute(
      act_kernel<TASK, INTEG, STOCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (pl.n + ACT_THREADS - 1) / ACT_THREADS;
  act_kernel<TASK, INTEG, STOCH>
      <<<blocks, ACT_THREADS, smem, stream>>>(pf, pi, pl, tw, weights, T);
  return cudaGetLastError();
}

template <int TASK, int INTEG>
cudaError_t launch_mode(const float* pf, const int* pi, const Planes& pl,
                        const Tower& tw, const float4* weights, int T,
                        bool stochastic, cudaStream_t stream) {
  return stochastic
             ? launch<TASK, INTEG, true>(pf, pi, pl, tw, weights, T, stream)
             : launch<TASK, INTEG, false>(pf, pi, pl, tw, weights, T, stream);
}

}  // namespace drone

// C interface (ctypes). pf/pi: device env params (NPF floats, 2 ints).
// layout: host ints [n_hidden, head_off, n_weights, maxw_p,
// width[MAX_HIDDEN], off[MAX_HIDDEN]]; stdv: host exp(log_std)[4]. The
// state planes, stats and the packed weights are device memory.
extern "C" int drone_act_rollout(const float* pf, const int* pi,
                                 const float* fs, const uint32_t* us,
                                 const int* st, float* ofs, uint32_t* ous,
                                 int* ost, float* stats, const float* weights,
                                 const int* layout, const float* stdv,
                                 int stochastic, int n, int T, int task,
                                 int integrator, void* stream) {
  using namespace drone;
  if (n <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  Tower tw;
  if (!read_tower(layout, tw)) return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k) tw.std[k] = stdv[k];
  const Planes pl{fs, us, st, ofs, ous, ost, stats, n};
  const float4* w = reinterpret_cast<const float4*>(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sto = stochastic != 0;
  if (task == TASK_HOVER && integrator == INTEG_EULER)
    return (int)launch_mode<TASK_HOVER, INTEG_EULER>(pf, pi, pl, tw, w, T, sto, s);
  if (task == TASK_HOVER && integrator == INTEG_RK4)
    return (int)launch_mode<TASK_HOVER, INTEG_RK4>(pf, pi, pl, tw, w, T, sto, s);
  if (task == TASK_WAYPOINT && integrator == INTEG_EULER)
    return (int)launch_mode<TASK_WAYPOINT, INTEG_EULER>(pf, pi, pl, tw, w, T, sto, s);
  if (task == TASK_WAYPOINT && integrator == INTEG_RK4)
    return (int)launch_mode<TASK_WAYPOINT, INTEG_RK4>(pf, pi, pl, tw, w, T, sto, s);
  if (task == TASK_RACING && integrator == INTEG_EULER)
    return (int)launch_mode<TASK_RACING, INTEG_EULER>(pf, pi, pl, tw, w, T, sto, s);
  if (task == TASK_RACING && integrator == INTEG_RK4)
    return (int)launch_mode<TASK_RACING, INTEG_RK4>(pf, pi, pl, tw, w, T, sto, s);
  return (int)cudaErrorInvalidValue;
}
