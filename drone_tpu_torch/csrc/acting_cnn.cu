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
// Design: a block of 256 threads owns a tile of 64 lanes (cnn.cuh). Per
// step the first 64 threads, one lane each, observe their lane (env.cuh's
// Carry stays in registers for the whole loop, as in K5 and K2), store the
// obs planes and its 12 splat scalars; then every thread takes part in the
// encoder, window by window (render a patch -> conv0, four times; conv1;
// the window's share of the trunk into sums held in registers); then the
// lane threads run the heads, the noise and log-prob (policy.cuh), the env
// step and the planes. Shared memory: the splat scalars, one rendered
// patch, one window's conv0 output and its conv1 output, 99 KB, so two
// blocks share an SM. A ragged last tile computes on zeros for its lanes
// past n and stores nothing for them.
//
// What bounds it on an H100: ~369k multiply-adds per lane-step (conv0
// 147,456, conv1 147,456, trunk 73,728, heads 640) and 2,304 expf on the
// fp32 cores; the env step is ~1% beside them and the planes 84 bytes a
// lane-step. The weights stream from L2 (cnn.cuh). Tensor cores wait:
// TF32 would break the tolerance, and 3xTF32 through wgmma is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "cnn.cuh"
#include "env.cuh"

namespace drone {

constexpr int ACT_L = 64;  // lanes of a tile
constexpr int ACT_S = ACT_L;
// shared floats: splat scalars (12 rows), a patch (64), a window's conv0
// output (256, later h), its conv1 output (64)
constexpr int ACT_SMEM_FLOATS = (12 + CNN_K0 + CNN_K1 + CNN_C1) * ACT_S;

struct CnnIO {
  const float* theta;  // flat parameters
  const float* wt;     // W0^T, W1^T, Wt^T (cnn.cuh T_*)
  const float* grid;   // gx, gy: (2, 576)
  float* traj;         // (T, 21, n), or null when serving
  int T, stochastic;
};

template <int TASK, int INTEG>
__global__ void __launch_bounds__(CNN_THREADS, 2)
cnn_act_kernel(const float* __restrict__ pf, const int* __restrict__ pi,
               Planes pl, CnnIO io) {
  constexpr int L = ACT_L, S = ACT_S;
  extern __shared__ float4 smem4[];
  __shared__ EnvP P;
  float* sp = reinterpret_cast<float*>(smem4);
  float* xr = sp + 12 * S;
  float* y0 = xr + CNN_K0 * S;
  float* y1 = y0 + CNN_K1 * S;
  float* h = y0;  // the trunk's output, once the last window is done
  const int n = pl.n;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * L + tid;
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

    cnn_encode_tile<L, S>(sp, io.theta, io.wt, io.grid, xr, y0, y1, h,
                          NoWindowOut{});
    __syncthreads();

    if (lane_thread) {
      float m[4], v, a[4];
      cnn_heads(h, S, tid, io.theta, m, v);
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
    // and h is rewritten only after two more
  }
  if (lane_thread) write_back(pl, i, cr, acc);
}

template <int TASK, int INTEG>
cudaError_t launch(const float* pf, const int* pi, const Planes& pl,
                   const CnnIO& io, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)ACT_SMEM_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      cnn_act_kernel<TASK, INTEG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cnn_act_kernel<TASK, INTEG>
      <<<(pl.n + ACT_L - 1) / ACT_L, CNN_THREADS, smem, stream>>>(pf, pi, pl,
                                                                   io);
  return cudaGetLastError();
}

}  // namespace drone

// C interface (ctypes). pf/pi: device env params; fs..stats: the state and
// statistic planes of rollout.cu; theta: the flat parameters (95,113); wt:
// the transposed weights (94,208); grid: the pixel coordinates (2, 576);
// traj: the (T, 21, n) planes to train (K9), or null to serve (K11).
extern "C" int drone_cnn_act_rollout(
    const float* pf, const int* pi, const float* fs, const uint32_t* us,
    const int* st, float* ofs, uint32_t* ous, int* ost, float* stats,
    const float* theta, const float* wt, const float* grid, float* traj,
    int stochastic, int n, int T, int task, int integrator, void* stream) {
  using namespace drone;
  if (n <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  const CnnIO io{theta, wt, grid, traj, T, stochastic};
  const Planes pl{fs, us, st, ofs, ous, ost, stats, n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DRONE_CNN_CASE(TK, IG) \
  if (task == TK && integrator == IG) return (int)launch<TK, IG>(pf, pi, pl, io, s);
  DRONE_CNN_CASE(TASK_HOVER, INTEG_EULER)
  DRONE_CNN_CASE(TASK_HOVER, INTEG_RK4)
  DRONE_CNN_CASE(TASK_WAYPOINT, INTEG_EULER)
  DRONE_CNN_CASE(TASK_WAYPOINT, INTEG_RK4)
  DRONE_CNN_CASE(TASK_RACING, INTEG_EULER)
  DRONE_CNN_CASE(TASK_RACING, INTEG_RK4)
#undef DRONE_CNN_CASE
  return (int)cudaErrorInvalidValue;
}
