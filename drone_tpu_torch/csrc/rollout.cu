// rollout.cu — the env megakernel: T env steps per lane per launch.
//
// Replaces drone_tpu/ops/pallas_rollout.py `_rollout_kernel` (driven by
// `rollout_pallas`). Wrapper and plain version: ops/cuda_rollout.py.
//
// Design: one thread per lane. The lane's state is read once from
// structure-of-arrays planes in device memory (19 f32, 4 u32, 2 i32, each
// of length n), advanced T steps in registers (mix -> integrate -> reward ->
// progression -> termination -> branch-free auto-reset, env.cuh), and
// written once with 5 per-lane statistic planes, which the wrapper reduces
// with torch.sum. Actions come either from the lane's threefry stream at
// block ACTION_BLOCK0 + 2*step (step = the lane's carried episode-step
// counter) or from a provided (T, n, 4) f32 stream, read as one float4 per
// lane-step (neighbouring lanes on neighbouring 16 bytes).
//
// What bounds it on an H100: integer and f32 ALU issue. A lane-step moves
// no bytes beyond an optional 16-byte action, while the always-computed
// reset costs 7 (9 for waypoint) threefry blocks of ~80 integer ops each,
// and the in-kernel actions 2 more, beside ~300 f32 ops of physics and
// reward. The design keeps everything in registers and launches enough
// lanes (65,536 = 512 blocks of 128) to cover the 132 SMs; computing the
// reset only on lanes that are done is left for a later change.

#include <cuda_runtime.h>

#include <cstdint>

#include "env.cuh"

namespace drone {

constexpr int ROLLOUT_THREADS = 128;

template <int TASK, int INTEG, bool WITH_ACTIONS>
__global__ void __launch_bounds__(ROLLOUT_THREADS)
rollout_kernel(const float* __restrict__ pf, const int* __restrict__ pi,
               Planes pl, const float4* __restrict__ actions, int T) {
  __shared__ EnvP P;
  load_params(pf, pi, P);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pl.n) return;  // no barrier follows
  Carry c = read_carry(pl, i);
  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < T; ++t) {
    float a0, a1, a2, a3;
    if (WITH_ACTIONS) {
      const float4 a = actions[(size_t)t * pl.n + i];
      a0 = a.x;
      a1 = a.y;
      a2 = a.z;
      a3 = a.w;
    } else {
      const uint32_t jb = ACTION_BLOCK0 + 2u * (uint32_t)c.stp;
      uint32_t b0, b1, b2, b3;
      threefry2x32(c.k0, c.k1, c.rc, jb, b0, b1);
      threefry2x32(c.k0, c.k1, c.rc, jb + 1u, b2, b3);
      a0 = uniform01(b0) * 2.0f - 1.0f;
      a1 = uniform01(b1) * 2.0f - 1.0f;
      a2 = uniform01(b2) * 2.0f - 1.0f;
      a3 = uniform01(b3) * 2.0f - 1.0f;
    }
    float r, epret2;
    bool done;
    int step2;
    env_step<TASK, INTEG>(c, a0, a1, a2, a3, P, r, done, epret2, step2);
    accumulate(acc, r, done, epret2, step2);
  }
  write_back(pl, i, c, acc);
}

template <int TASK, int INTEG>
cudaError_t launch(const float* pf, const int* pi, const Planes& pl,
                   const float4* actions, int T, cudaStream_t stream) {
  const int blocks = (pl.n + ROLLOUT_THREADS - 1) / ROLLOUT_THREADS;
  if (actions != nullptr)
    rollout_kernel<TASK, INTEG, true>
        <<<blocks, ROLLOUT_THREADS, 0, stream>>>(pf, pi, pl, actions, T);
  else
    rollout_kernel<TASK, INTEG, false>
        <<<blocks, ROLLOUT_THREADS, 0, stream>>>(pf, pi, pl, actions, T);
  return cudaGetLastError();
}

}  // namespace drone

// C interface (ctypes). All pointers are device memory: pf/pi hold NPF
// floats and 2 ints of env params; actions may be null (in-kernel stream).
// Returns the cudaError_t of the launch.
extern "C" int drone_rollout(const float* pf, const int* pi, const float* fs,
                             const uint32_t* us, const int* st, float* ofs,
                             uint32_t* ous, int* ost, float* stats,
                             const float* actions, int n, int T, int task,
                             int integrator, void* stream) {
  using namespace drone;
  if (n <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  const Planes pl{fs, us, st, ofs, ous, ost, stats, n};
  const float4* act = reinterpret_cast<const float4*>(actions);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (task == TASK_HOVER && integrator == INTEG_EULER)
    return (int)launch<TASK_HOVER, INTEG_EULER>(pf, pi, pl, act, T, s);
  if (task == TASK_HOVER && integrator == INTEG_RK4)
    return (int)launch<TASK_HOVER, INTEG_RK4>(pf, pi, pl, act, T, s);
  if (task == TASK_WAYPOINT && integrator == INTEG_EULER)
    return (int)launch<TASK_WAYPOINT, INTEG_EULER>(pf, pi, pl, act, T, s);
  if (task == TASK_WAYPOINT && integrator == INTEG_RK4)
    return (int)launch<TASK_WAYPOINT, INTEG_RK4>(pf, pi, pl, act, T, s);
  if (task == TASK_RACING && integrator == INTEG_EULER)
    return (int)launch<TASK_RACING, INTEG_EULER>(pf, pi, pl, act, T, s);
  if (task == TASK_RACING && integrator == INTEG_RK4)
    return (int)launch<TASK_RACING, INTEG_RK4>(pf, pi, pl, act, T, s);
  return (int)cudaErrorInvalidValue;
}
