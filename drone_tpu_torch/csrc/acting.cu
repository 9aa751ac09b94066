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
//     chunk, so its activations are never stored;
//   - the tower uses explicit fmaf: the env math is built with
//     --fmad=false for its bitwise contract, the tower is held to a
//     tolerance instead (its summation order differs from a matmul anyway).
// Tensor-core (wgmma) towers are work for a later change.

#include <cuda_runtime.h>

#include <cstdint>

#include "env.cuh"

namespace drone {

constexpr int ACT_THREADS = 128;
constexpr int MAX_HIDDEN = 8;
constexpr int MAX_WIDTH = 256;
constexpr int CHUNK = 16;
// float32(2*pi), as drone_tpu's jnp.float32(_TWO_PI) rounds it (0x40C90FDB).
constexpr float TWO_PI = 6.28318548202514648438f;

// Weight layout in the packed buffer (ops/cuda_acting.py pack_tower):
// hidden layer l at off[l]: W^T (nin, pad16(width[l])) then its bias
// (pad16(width[l])), with nin = 13 for l = 0 and width[l-1] after; the head
// at head_off: W^T (nin, 4) then its bias (4). Padding is zero.
struct Tower {
  int n_hidden, head_off, n_weights, maxw_p;
  int width[MAX_HIDDEN];
  int off[MAX_HIDDEN];
  float std[4];
};

__device__ __forceinline__ int pad16(int w) { return (w + CHUNK - 1) & ~(CHUNK - 1); }

// _tower: obs column -> 4 action means. `col_obs`, `col_a`, `col_b` are
// this thread's columns (stride B) of the block's activation buffers.
__device__ __forceinline__ void tower(const float* sw, const Tower& tw,
                                      const float* col_obs, float* col_a,
                                      float* col_b, int B, float a[4]) {
  const float4* wh4 = reinterpret_cast<const float4*>(sw + tw.head_off);
  float head[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const float* in = col_obs;
  int nin = OBS_DIM;
  for (int l = 0; l < tw.n_hidden; ++l) {
    const int nout = tw.width[l];
    const int np = pad16(nout);
    const float* W = sw + tw.off[l];
    const float* bias = W + nin * np;
    const bool last = l == tw.n_hidden - 1;
    float* out = (l & 1) ? col_b : col_a;
    for (int j0 = 0; j0 < np; j0 += CHUNK) {
      float acc[CHUNK];
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) acc[c] = 0.0f;
      for (int k = 0; k < nin; ++k) {
        const float x = in[k * B];
        const float4* w4 = reinterpret_cast<const float4*>(W + k * np + j0);
#pragma unroll
        for (int q = 0; q < CHUNK / 4; ++q) {
          const float4 w = w4[q];
          acc[4 * q + 0] = __fmaf_rn(w.x, x, acc[4 * q + 0]);
          acc[4 * q + 1] = __fmaf_rn(w.y, x, acc[4 * q + 1]);
          acc[4 * q + 2] = __fmaf_rn(w.z, x, acc[4 * q + 2]);
          acc[4 * q + 3] = __fmaf_rn(w.w, x, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int c = 0; c < CHUNK; ++c) {
        const float u = tanhf(acc[c] + bias[j0 + c]);
        if (!last) {
          out[(j0 + c) * B] = u;
        } else if (j0 + c < nout) {
          const float4 w = wh4[j0 + c];
          head[0] = __fmaf_rn(w.x, u, head[0]);
          head[1] = __fmaf_rn(w.y, u, head[1]);
          head[2] = __fmaf_rn(w.z, u, head[2]);
          head[3] = __fmaf_rn(w.w, u, head[3]);
        }
      }
    }
    in = out;
    nin = nout;
  }
  if (tw.n_hidden == 0) {  // linear policy: the head reads the obs
    for (int k = 0; k < OBS_DIM; ++k) {
      const float x = col_obs[k * B];
      const float4 w = wh4[k];
      head[0] = __fmaf_rn(w.x, x, head[0]);
      head[1] = __fmaf_rn(w.y, x, head[1]);
      head[2] = __fmaf_rn(w.z, x, head[2]);
      head[3] = __fmaf_rn(w.w, x, head[3]);
    }
  }
  const int head_rows = tw.n_hidden ? tw.width[tw.n_hidden - 1] : OBS_DIM;
  const float* hb = sw + tw.head_off + 4 * head_rows;
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = head[k] + hb[k];
}

// _gauss4_planes: 4 standard normals at blocks NOISE_BLOCK0 + 2*step (+1).
__device__ __forceinline__ void gauss4(uint32_t k0, uint32_t k1, uint32_t e,
                                       int stp, float z[4]) {
  const uint32_t jb = NOISE_BLOCK0 + 2u * (uint32_t)stp;
  uint32_t b0, b1, b2, b3;
  threefry2x32(k0, k1, e, jb, b0, b1);
  threefry2x32(k0, k1, e, jb + 1u, b2, b3);
  const float u1 = uniform01(b0), u2 = uniform01(b1);
  const float u3 = uniform01(b2), u4 = uniform01(b3);
  // 1-u in (0, 1]: log never sees 0
  const float r1 = sqrtf(-2.0f * logf(1.0f - u1));
  const float r2 = sqrtf(-2.0f * logf(1.0f - u3));
  const float a1 = TWO_PI * u2;
  const float a2 = TWO_PI * u4;
  z[0] = r1 * cosf(a1);
  z[1] = r1 * sinf(a1);
  z[2] = r2 * cosf(a2);
  z[3] = r2 * sinf(a2);
}

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
    tower(sw, tw, col_obs, col_a, col_b, B, a);
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

// Shared memory of one block: the weights, the obs column block and up to
// two hidden-activation column blocks (ping-pong for depth >= 3).
inline size_t smem_bytes(const Tower& tw) {
  const int nbuf = tw.n_hidden >= 3 ? 2 : (tw.n_hidden == 2 ? 1 : 0);
  return sizeof(float) *
         ((size_t)tw.n_weights + (size_t)(CHUNK + nbuf * tw.maxw_p) * ACT_THREADS);
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
  tw.n_hidden = layout[0];
  tw.head_off = layout[1];
  tw.n_weights = layout[2];
  tw.maxw_p = layout[3];
  if (tw.n_hidden < 0 || tw.n_hidden > MAX_HIDDEN || tw.n_weights % 4 != 0 ||
      tw.maxw_p > MAX_WIDTH)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < MAX_HIDDEN; ++l) {
    tw.width[l] = layout[4 + l];
    tw.off[l] = layout[4 + MAX_HIDDEN + l];
  }
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
