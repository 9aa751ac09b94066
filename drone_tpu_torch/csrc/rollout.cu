// rollout.cu — the env megakernel: T env steps per lane per launch.
//
// Replaces drone_tpu/ops/pallas_rollout.py `_rollout_kernel` (driven by
// `rollout_pallas`). Wrapper and plain version: ops/cuda_rollout.py.
//
// Design: one thread per lane. The lane's state is read once from
// structure-of-arrays planes in device memory (19 f32, 4 u32, 2 i32, each
// of length n), advanced T steps in registers (mix -> integrate -> reward ->
// progression -> termination, env_advance; auto-reset, env_select), and
// written once with 5 per-lane statistic planes, which the wrapper reduces
// with torch.sum. Actions come either from the lane's threefry stream at
// block ACTION_BLOCK0 + 2*step (step = the lane's carried episode-step
// counter) or from a provided (T, n, 4) f32 stream, read as one float4 per
// lane-step (neighbouring lanes on neighbouring 16 bytes).
//
// What bounds it on an H100: instruction throughput. A lane-step moves no bytes
// beyond an optional 16-byte action; it is ~500 SASS instructions (built
// with --fmad=false every add and multiply is one, IEEE division and sqrt
// ~10 each), ~160 of them int32 (the in-kernel actions' 2 threefry
// blocks), which run at half the fp32 rate. A reset is 7 blocks (9 for
// waypoint) and init_pose, ~600 more, but only about one lane-step in 50
// ends an episode under random actions. So the warp computes the reset
// together (warp_fresh), only for its lanes that are done, each of its
// threads drawing one block of one of them; every value comes from the
// same expressions as env_step's, so the kernel stays bitwise equal to the
// plain version. Blocks of 256 lanes (86 registers, no spills) measured
// faster than 64 or 128, and than two lanes a thread, at 65,536 lanes
// (scripts/k1_variants.py).

#include <cuda_runtime.h>

#include <cstdint>

#include "env.cuh"

namespace drone {

constexpr int ROLLOUT_THREADS = 256;
constexpr unsigned FULL_WARP = 0xffffffffu;

// env.reset_state for the warp's lanes that are done: each pass serves the
// lowest 32 / NB of them (NB = fresh_blocks<TASK>(): 4 lanes a pass for
// hover and racing, 3 for waypoint), thread t drawing block t % NB of
// pass lane t / NB's episode rc + 1 (its keys and counter by shuffles).
// Each served lane gathers its 2 NB uniforms by shuffles and runs
// fresh_state's tail; passes repeat while lanes are left. Fills f on the
// lanes that are done only. Every thread of the warp must call it.
template <int TASK>
__device__ __forceinline__ void warp_fresh(const Carry& c, bool done,
                                           const EnvP& P, Fresh& f) {
  constexpr int NB = fresh_blocks<TASK>();
  constexpr int PER = 32 / NB;
  const int lane = threadIdx.x & 31;
  const int slot = lane / NB;
  const uint32_t blk = (uint32_t)(lane - slot * NB);
  const uint32_t e2 = c.rc + 1u;
  unsigned left = __ballot_sync(FULL_WARP, done);
  while (left != 0u) {
    // this pass's lanes: the lowest PER set bits of `left`; src = the one
    // this thread draws for (-1 past the last)
    unsigned rest = left;
    int src = -1;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int p = __ffs(rest) - 1;
      src = k == slot ? p : src;
      rest &= rest - 1u;
    }
    const unsigned served = left & ~rest;
    const int from = src < 0 ? 0 : src;
    const uint32_t k0 = __shfl_sync(FULL_WARP, c.k0, from);
    const uint32_t k1 = __shfl_sync(FULL_WARP, c.k1, from);
    const uint32_t e = __shfl_sync(FULL_WARP, e2, from);
    float u0 = 0.0f, u1 = 0.0f;
    if (src >= 0) fresh_uniforms(k0, k1, e, blk, u0, u1);
    // a served lane's blocks are on threads base .. base + NB - 1
    const int base = __popc(served & ((1u << lane) - 1u)) * NB;
    float u[2 * NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      u[2 * j] = __shfl_sync(FULL_WARP, u0, (base + j) & 31);
      u[2 * j + 1] = __shfl_sync(FULL_WARP, u1, (base + j) & 31);
    }
    if ((served >> lane) & 1u) fresh_from_uniforms<TASK>(u, P, f);
    left = rest;
  }
}

template <int TASK, int INTEG, bool WITH_ACTIONS>
__global__ void __launch_bounds__(ROLLOUT_THREADS)
rollout_kernel(const float* __restrict__ pf, const int* __restrict__ pi,
               Planes pl, const float4* __restrict__ actions, int T) {
  __shared__ EnvP P;
  load_params(pf, pi, P);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // the warp's shuffles need all its threads: a warp with a lane below n
  // runs whole, its lanes past n never done and never stored
  if (i - (int)(threadIdx.x & 31) >= pl.n) return;  // no barrier follows
  const bool live = i < pl.n;
  Carry c = {};
  if (live) c = read_carry(pl, i);
  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < T; ++t) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    if (WITH_ACTIONS) {
      if (live) {
        const float4 a = actions[(size_t)t * pl.n + i];
        a0 = a.x;
        a1 = a.y;
        a2 = a.z;
        a3 = a.w;
      }
    } else {
      stream_actions(c.k0, c.k1, c.rc, c.stp, a0, a1, a2, a3);
    }
    Advance v;
    float r, epret2;
    bool done;
    int step2;
    env_advance<TASK, INTEG>(c, a0, a1, a2, a3, P, v, r, done, epret2,
                             step2);
    done = done && live;
    Fresh f = {};  // warp_fresh fills it on the lanes that are done
    warp_fresh<TASK>(c, done, P, f);
    env_select(c, v, f, done, epret2, step2);
    accumulate(acc, r, done, epret2, step2);
  }
  if (live) write_back(pl, i, c, acc);
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
