// acting_traj.cu — the trajectory rollout kernel (K2): actor + critic +
// exploration noise + env step for T steps per lane, streaming the PPO
// training planes.
//
// Replaces drone_tpu/ops/pallas_acting_traj.py `_traj_kernel` (driven by
// `traj_act_rollout_pallas_planes`; the megakernel trainer's rollout).
// Wrapper and plain version: ops/cuda_acting_traj.py.
//
// Design: one thread per lane over the env loop of env.cuh, with both fp32
// towers of policy.cuh evaluated in the thread before each env step. Per
// lane-step it writes the 21 planes obs(13) act(4) logp value reward done
// in the reference's TP_* order, time-major as (T, 21, n): thread i writes
// lane i, so every store of a warp is one coalesced 128-byte run. The
// action's log-prob is rebuilt from the stored action (_sample_logp), with
// std = expf(log_std) computed here from the parameter buffer: a launch
// needs no host copy of it.
//
// The weights come straight from the trainer's flat parameter buffer (the
// reference's _kernel_tensors order: per layer W (out, in) then b, actor
// then critic, then log_std). Each block stages both towers into shared
// memory in policy.cuh's layout (W^T, outputs padded to 16), transposing as
// it copies; the staging reads ~40 KB per block from L2.
//
// What bounds it on an H100: the two towers' multiply-adds on the fp32
// cores (10,433 per lane-step for [64, 64]) and one tanhf per hidden unit,
// beside the env step; its 21 planes are 84 bytes per lane-step, far below
// the memory rate. So the weights sit in shared memory, read as
// broadcasts, and the activations in the thread's own shared-memory column.

#include <cuda_runtime.h>

#include <cstdint>

#include "env.cuh"
#include "policy.cuh"

namespace drone {

constexpr int TRAJ_THREADS = 128;

// Where each layer of a tower starts in the flat parameter buffer: W of
// layer l (hidden layers, then the head) at w[l], its bias right after.
struct TowerSrc {
  int w[MAX_HIDDEN + 1];
};

// Copy one tower from the flat buffer (W (out, in), b (out,)) into the
// shared-memory layout of policy.cuh. Every thread of the block takes part.
template <int NH>
__device__ void stage_tower(float* sw, const Tower& tw, const TowerSrc& src,
                            const float* __restrict__ theta) {
  int nin = OBS_DIM;
  for (int l = 0; l < tw.n_hidden; ++l) {
    const int nout = tw.width[l];
    const int np = pad16(nout);
    const float* W = theta + src.w[l];
    const float* b = W + nout * nin;
    float* dst = sw + tw.off[l];
    for (int k = threadIdx.x; k < (nin + 1) * np; k += blockDim.x) {
      const int r = k / np, j = k % np;
      float v = 0.0f;
      if (j < nout) v = r < nin ? W[j * nin + r] : b[j];
      dst[k] = v;
    }
    nin = nout;
  }
  const float* W = theta + src.w[tw.n_hidden];
  float* dst = sw + tw.head_off;
  for (int k = threadIdx.x; k < (nin + 1) * NH; k += blockDim.x) {
    const int r = k / NH, h = k % NH;
    dst[k] = r < nin ? W[h * nin + r] : W[NH * nin + h];
  }
}

template <int TASK, int INTEG, bool STOCH>
__global__ void __launch_bounds__(TRAJ_THREADS)
traj_kernel(const float* __restrict__ pf, const int* __restrict__ pi,
            Planes pl, float* __restrict__ traj, Tower ta, Tower tc,
            TowerSrc sa, TowerSrc sc, const float* __restrict__ theta,
            int ls_off, int T) {
  extern __shared__ float4 smem4[];
  __shared__ EnvP P;
  float* sw_a = reinterpret_cast<float*>(smem4);
  float* sw_c = sw_a + ta.n_weights;
  stage_tower<4>(sw_a, ta, sa, theta);
  stage_tower<1>(sw_c, tc, sc, theta);
  load_params(pf, pi, P);  // ends with the barrier the copies need
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pl.n) return;  // no barrier follows

  const int B = blockDim.x;
  const int n = pl.n;
  float* col_obs = sw_c + tc.n_weights + threadIdx.x;
  float* col_a = col_obs + CHUNK * B;
  float* col_b = col_a + (ta.maxw_p > tc.maxw_p ? ta.maxw_p : tc.maxw_p) * B;
  float ls[4], stdv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ls[k] = theta[ls_off + k];
    stdv[k] = expf(ls[k]);
  }

  Carry c = read_carry(pl, i);
  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < T; ++t) {
    float* out = traj + (size_t)t * N_TRAJ * n + i;
    float o[OBS_DIM];
    observe(c, o);
#pragma unroll
    for (int k = 0; k < OBS_DIM; ++k) {
      col_obs[k * B] = o[k];
      out[(size_t)k * n] = o[k];
    }
    float m[4], v[1];
    tower<4>(sw_a, ta, col_obs, col_a, col_b, B, m);
    tower<1>(sw_c, tc, col_obs, col_a, col_b, B, v);
    float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (STOCH) gauss4(c.k0, c.k1, c.rc, c.stp, z);
    // _sample_logp: the log-prob of the stored action
    float a[4], logp;
    sample_logp(m, z, ls, stdv, STOCH, a, logp);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[(size_t)(TP_ACT0 + k) * n] = a[k];
    out[(size_t)TP_LOGP * n] = logp;
    out[(size_t)TP_VAL * n] = v[0];
    float r, epret2;
    bool done;
    int step2;
    env_step<TASK, INTEG>(c, a[0], a[1], a[2], a[3], P, r, done, epret2,
                          step2);
    out[(size_t)TP_REW * n] = r;
    out[(size_t)TP_DONE * n] = done ? 1.0f : 0.0f;
    accumulate(acc, r, done, epret2, step2);
  }
  write_back(pl, i, c, acc);
}

inline size_t smem_bytes(const Tower& ta, const Tower& tc) {
  Tower wide = ta;
  wide.maxw_p = ta.maxw_p > tc.maxw_p ? ta.maxw_p : tc.maxw_p;
  return sizeof(float) * ((size_t)ta.n_weights + (size_t)tc.n_weights +
                          (size_t)activation_floats(wide, TRAJ_THREADS));
}

template <int TASK, int INTEG, bool STOCH>
cudaError_t launch(const float* pf, const int* pi, const Planes& pl,
                   float* traj, const Tower& ta, const Tower& tc,
                   const TowerSrc& sa, const TowerSrc& sc, const float* theta,
                   int ls_off, int T, cudaStream_t stream) {
  const size_t smem = smem_bytes(ta, tc);
  cudaError_t err = cudaFuncSetAttribute(
      traj_kernel<TASK, INTEG, STOCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (pl.n + TRAJ_THREADS - 1) / TRAJ_THREADS;
  traj_kernel<TASK, INTEG, STOCH><<<blocks, TRAJ_THREADS, smem, stream>>>(
      pf, pi, pl, traj, ta, tc, sa, sc, theta, ls_off, T);
  return cudaGetLastError();
}

template <int TASK, int INTEG>
cudaError_t launch_mode(const float* pf, const int* pi, const Planes& pl,
                        float* traj, const Tower& ta, const Tower& tc,
                        const TowerSrc& sa, const TowerSrc& sc,
                        const float* theta, int ls_off, int T, bool stochastic,
                        cudaStream_t stream) {
  return stochastic
             ? launch<TASK, INTEG, true>(pf, pi, pl, traj, ta, tc, sa, sc,
                                         theta, ls_off, T, stream)
             : launch<TASK, INTEG, false>(pf, pi, pl, traj, ta, tc, sa, sc,
                                          theta, ls_off, T, stream);
}

}  // namespace drone

// C interface (ctypes). pf/pi: device env params; fs..stats: the state and
// statistic planes of rollout.cu; traj: device (T, 21, n) float32; theta:
// the device flat parameter buffer. layout: host ints, for the actor then
// the critic, each the Tower ints of policy.cuh (read_tower) followed by
// MAX_HIDDEN + 1 layer offsets into theta, then log_std's offset.
extern "C" int drone_traj_rollout(const float* pf, const int* pi,
                                  const float* fs, const uint32_t* us,
                                  const int* st, float* ofs, uint32_t* ous,
                                  int* ost, float* stats, float* traj,
                                  const float* theta, const int* layout,
                                  int stochastic, int n, int T, int task,
                                  int integrator, void* stream) {
  using namespace drone;
  if (n <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  constexpr int TOWER_INTS = 4 + 2 * MAX_HIDDEN;
  constexpr int PER_TOWER = TOWER_INTS + MAX_HIDDEN + 1;
  Tower ta, tc;
  TowerSrc sa, sc;
  if (!read_tower(layout, ta) || !read_tower(layout + PER_TOWER, tc))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l <= MAX_HIDDEN; ++l) {
    sa.w[l] = layout[TOWER_INTS + l];
    sc.w[l] = layout[PER_TOWER + TOWER_INTS + l];
  }
  const int ls_off = layout[2 * PER_TOWER];
  for (int k = 0; k < 4; ++k) ta.std[k] = tc.std[k] = 0.0f;
  const Planes pl{fs, us, st, ofs, ous, ost, stats, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sto = stochastic != 0;
#define DRONE_TRAJ_CASE(TK, IG)                                           \
  if (task == TK && integrator == IG)                                     \
    return (int)launch_mode<TK, IG>(pf, pi, pl, traj, ta, tc, sa, sc,     \
                                    theta, ls_off, T, sto, s);
  DRONE_TRAJ_CASE(TASK_HOVER, INTEG_EULER)
  DRONE_TRAJ_CASE(TASK_HOVER, INTEG_RK4)
  DRONE_TRAJ_CASE(TASK_WAYPOINT, INTEG_EULER)
  DRONE_TRAJ_CASE(TASK_WAYPOINT, INTEG_RK4)
  DRONE_TRAJ_CASE(TASK_RACING, INTEG_EULER)
  DRONE_TRAJ_CASE(TASK_RACING, INTEG_RK4)
#undef DRONE_TRAJ_CASE
  return (int)cudaErrorInvalidValue;
}
