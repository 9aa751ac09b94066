// acting.cu — the MLP acting megakernel: policy + env for T steps per lane.
//
// Replaces drone_tpu/ops/pallas_acting.py `_acting_kernel` (driven by
// `act_rollout_pallas`; evaluate()'s path). Wrapper and plain version:
// ops/cuda_acting.py.
//
// Design: one thread per lane runs the env loop of rollout.cu (env.cuh)
// and the Box-Muller draw (policy.cuh gauss4), and the lanes of a warp
// evaluate the actor tower together before each step, as one product per
// layer on the tensor cores (mma.sync m16n8k8 in 3xTF32, mma.cuh): M = the
// warp's 32 lanes (2 m-tiles), K = the layer's inputs padded to 8 (the 13
// obs to 16), N = its outputs padded to 8 (the 4 means to 8). Tanh hidden
// layers of any depth (up to MAX_HIDDEN, widths up to MAX_WIDTH) and a
// linear head. Deterministic mode acts with the mean; stochastic mode adds
// exp(log_std) * z with z from Box-Muller over the lane's threefry stream
// at NOISE_BLOCK0 + 2*step (_gauss4_planes).
//
// A warp's activations are rows of the block's lanes in shared memory
// (tower_mma.cuh, with the products K2 shares). Each lane writes its obs
// into its column; the layers but the last hidden one write their outputs
// (tanh on the accumulators, padded units 0) into the next buffer,
// ping-pong; the last hidden layer runs 16 units at a time, each chunk's
// tanh written over the obs rows (which layer 0 has read) and multiplied
// at once into the head's accumulators, so its activations never need a
// buffer of their own (the fp32 kernel's fold, as products). Each thread
// reads its own lane's 4 means back. Only __syncwarp orders a step's
// layers: no block barrier inside the step loop. Lanes past n take part in
// the warp's products with zero obs and store nothing; a warp with no lane
// to step returns.
//
// Weights: packed once per call by the wrapper (ops/cuda_acting.py
// pack_tower_mma) into (big, small) fragments in the order a warp reads
// them (a float4 a lane a k x n tile, cnn_mma.cuh's layout), then the
// padded biases; staged in each block's shared memory (45,600 bytes at
// [64, 64]), or read from L2 and L1 when a tower's weights leave too few
// lanes beside them (act_layout).
//
// Residency at [64, 64]: 512 lanes a block (16 warps), 212,000 bytes of
// shared memory (weights, and 80 rows of 520 floats), one block an SM:
// 65,536 lanes are 128 blocks, one wave on 132 SMs.
//
// What bounds it on an H100: the tower's 5,184 multiply-adds a lane-step
// at [64, 64] (5,632 with the padding) at the 3xTF32 rate, 4.6 ms at
// 65,536 lanes x 1,001 steps with the env step; what holds it is the
// mma.sync TF32 rate, the operands' split and the 128 tanhf a lane-step on
// the CUDA cores. An fp32 tower, one thread a lane, at this residency was
// measured too, and is slower (PERF.md).

#include <cuda_runtime.h>

#include <cstdint>

#include "env.cuh"
#include "policy.cuh"
#include "tower_mma.cuh"

namespace drone {

constexpr int ACT_MAX_LANES = 512;
constexpr int ACT_MAX_SMEM = 232448 - 256;  // less the env params' copy

// The tower's layout (ops/cuda_acting.py act_layout mirrors it): the
// block's lanes `bl` and row stride `as`; the activation buffers' first
// rows (obs, the fold chunk, ping and pong) and their rows in all; the
// weights buffer's floats `wfl` and whether it sits in shared memory.
struct ALayout {
  int L, bl, as, wfl, wsm;
  int obs, ch, ha, hb, rows;
  ALayer ly[MAX_HIDDEN + 1];
  float std[4];
};

// The layout of a tower of L hidden layers `width` at bl lanes a block.
inline void make_act_layout(int L, const int* width, int bl, int wsm,
                            ALayout& lo) {
  lo.L = L;
  lo.bl = bl;
  lo.as = bl + 8;
  lo.wsm = wsm;
  int fo = 0, nin = OBS_DIM, mw = 0;
  for (int l = 0; l <= L; ++l) {
    ALayer& y = lo.ly[l];
    y.nin = nin;
    y.nout = l < L ? width[l] : 4;
    y.fo = fo;
    fo += act_up8(nin) * act_up8(y.nout) / 2;  // a float4 holds 2 of B
    if (l + 2 <= L && act_up8(y.nout) > mw) mw = act_up8(y.nout);
    nin = y.nout;
  }
  int bo = 4 * fo;
  for (int l = 0; l <= L; ++l) {
    lo.ly[l].bo = bo;
    bo += act_up8(lo.ly[l].nout);
  }
  lo.wfl = (bo + 3) & ~3;
  lo.obs = 0;
  lo.ch = L == 1 ? TOWER_OBS_ROWS : 0;
  lo.ha = TOWER_OBS_ROWS + (L == 1 ? TOWER_CHUNK : 0);
  lo.hb = lo.ha + (L >= 2 ? mw : 0);
  lo.rows = lo.hb + (L >= 3 ? mw : 0);
}

// Dynamic shared memory of a block.
inline size_t act_smem(const ALayout& lo) {
  return sizeof(float) *
         ((lo.wsm ? (size_t)lo.wfl : 0) + (size_t)lo.rows * lo.as);
}

// The actor tower for the warp's 32 lanes: obs rows (written, then a
// __syncwarp) -> the 4 means of this thread's lane. act: the warp's first
// column of the buffers.
__device__ __forceinline__ void warp_tower(const ALayout& lo,
                                           const float4* W, float* act,
                                           float out[4]) {
  const float* wf = reinterpret_cast<const float*>(W);
  const int as = lo.as, L = lo.L;
  const ALayer& hd = lo.ly[L];
  float hacc[2][1][4];
  zero_frags(hacc);
  int in_row = lo.obs;
  for (int l = 0; l + 1 < L; ++l) {  // the layers before the last hidden
    const ALayer& y = lo.ly[l];
    const int out_row = (l & 1) ? lo.hb : lo.ha, NT = act_up8(y.nout) / 8;
    for (int nt0 = 0; nt0 < NT; nt0 += 4) {
      float acc[2][4][4];
      zero_frags(acc);
      warp_mma(act + in_row * as, as, act_up8(y.nin), W + y.fo, NT, nt0,
               min(4, NT - nt0), acc);
      store_tanh(acc, min(4, NT - nt0), nt0, out_row + 8 * nt0, wf + y.bo,
                 act, as);
    }
    __syncwarp();
    in_row = out_row;
  }
  if (L > 0) {  // the last hidden layer, folded into the head by chunks
    const ALayer& y = lo.ly[L - 1];
    const int NT = act_up8(y.nout) / 8;
    for (int nt0 = 0; nt0 < NT; nt0 += TOWER_CHUNK / 8) {
      const int nv = min(TOWER_CHUNK / 8, NT - nt0);
      float acc[2][TOWER_CHUNK / 8][4];
      zero_frags(acc);
      warp_mma(act + in_row * as, as, act_up8(y.nin), W + y.fo, NT, nt0, nv,
               acc);
      store_tanh(acc, nv, nt0, lo.ch, wf + y.bo, act, as);
      __syncwarp();
      warp_mma(act + lo.ch * as, as, 8 * nv, W + hd.fo + nt0 * 32, 1, 0, 1,
               hacc);
      __syncwarp();  // the chunk rows are read
    }
  } else {
    warp_mma(act + lo.obs * as, as, TOWER_OBS_ROWS, W + hd.fo, 1, 0, 1,
             hacc);
    __syncwarp();  // the obs rows are read
  }
  // the means (columns 0..3 of the head's n-tile) over obs rows 0..3
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (t < 2)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = 2 * t + (r & 1), m = 16 * i + g + (r & 2 ? 8 : 0);
        act[(lo.obs + n) * as + m] = hacc[i][0][r] + wf[hd.bo + n];
      }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; ++k) out[k] = act[(lo.obs + k) * as + lane];
}

template <int TASK, int INTEG, bool STOCH>
__global__ void __launch_bounds__(ACT_MAX_LANES, 1)
act_kernel(const float* __restrict__ pf, const int* __restrict__ pi,
           Planes pl, ALayout lo, const float4* __restrict__ weights, int T) {
  extern __shared__ float4 smem4[];
  __shared__ EnvP P;
  const float4* W = weights;
  float* buf = reinterpret_cast<float*>(smem4);
  if (lo.wsm) {
    for (int k = threadIdx.x; k < lo.wfl / 4; k += blockDim.x)
      smem4[k] = weights[k];
    W = smem4;
    buf += lo.wfl;
  }
  const int lane = threadIdx.x & 31;
  float* act = buf + (threadIdx.x - lane);  // the warp's first column
  for (int r = OBS_DIM; r < TOWER_OBS_ROWS; ++r)  // the obs' k padding
    act[(lo.obs + r) * lo.as + lane] = 0.0f;
  load_params(pf, pi, P);  // ends with the barrier both copies need
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < pl.n;
  if (!__any_sync(0xffffffffu, live)) return;  // no barrier follows

  Carry c{};
  if (live) c = read_carry(pl, i);
  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < T; ++t) {
    float o[OBS_DIM];
    observe(c, o);
#pragma unroll
    for (int k = 0; k < OBS_DIM; ++k)
      act[(lo.obs + k) * lo.as + lane] = live ? o[k] : 0.0f;
    __syncwarp();
    float a[4];
    warp_tower(lo, W, act, a);
    if (!live) continue;
    if (STOCH) {
      float z[4];
      gauss4(c.k0, c.k1, c.rc, c.stp, z);
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = a[k] + lo.std[k] * z[k];
    }
    float r, epret2;
    bool done;
    int step2;
    env_step<TASK, INTEG>(c, a[0], a[1], a[2], a[3], P, r, done, epret2,
                          step2);
    accumulate(acc, r, done, epret2, step2);
  }
  if (live) write_back(pl, i, c, acc);
}

template <int TASK, int INTEG, bool STOCH>
cudaError_t launch(const float* pf, const int* pi, const Planes& pl,
                   const ALayout& lo, const float4* weights, int T,
                   cudaStream_t stream) {
  const size_t smem = act_smem(lo);
  cudaError_t err = cudaFuncSetAttribute(
      act_kernel<TASK, INTEG, STOCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (pl.n + lo.bl - 1) / lo.bl;
  act_kernel<TASK, INTEG, STOCH>
      <<<blocks, lo.bl, smem, stream>>>(pf, pi, pl, lo, weights, T);
  return cudaGetLastError();
}

template <int TASK, int INTEG>
cudaError_t launch_mode(const float* pf, const int* pi, const Planes& pl,
                        const ALayout& lo, const float4* weights, int T,
                        bool stochastic, cudaStream_t stream) {
  return stochastic
             ? launch<TASK, INTEG, true>(pf, pi, pl, lo, weights, T, stream)
             : launch<TASK, INTEG, false>(pf, pi, pl, lo, weights, T, stream);
}

}  // namespace drone

// C interface (ctypes). pf/pi: device env params (NPF floats, 2 ints).
// layout: host ints [n_hidden, lanes a block, weights in shared memory (0 or
// 1), dynamic shared memory bytes, weights floats, width[MAX_HIDDEN]],
// the last two the kernel's own (ops/cuda_acting.py act_layout); stdv:
// host exp(log_std)[4]. The state planes, stats and the packed weights
// (pack_tower_mma) are device memory.
extern "C" int drone_act_rollout(const float* pf, const int* pi,
                                 const float* fs, const uint32_t* us,
                                 const int* st, float* ofs, uint32_t* ous,
                                 int* ost, float* stats, const float* weights,
                                 const int* layout, const float* stdv,
                                 int stochastic, int n, int T, int task,
                                 int integrator, void* stream) {
  using namespace drone;
  const int L = layout[0], bl = layout[1];
  if (n <= 0 || T < 0 || L < 0 || L > MAX_HIDDEN || bl < 32 ||
      bl > ACT_MAX_LANES || bl % 32 != 0)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l)
    if (layout[5 + l] <= 0 || layout[5 + l] > MAX_WIDTH)
      return (int)cudaErrorInvalidValue;
  ALayout lo;
  make_act_layout(L, layout + 5, bl, layout[2] != 0, lo);
  if ((size_t)layout[3] != act_smem(lo) || layout[4] != lo.wfl ||
      act_smem(lo) > (size_t)ACT_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < 4; ++k) lo.std[k] = stdv[k];
  const Planes pl{fs, us, st, ofs, ous, ost, stats, n};
  const float4* w = reinterpret_cast<const float4*>(weights);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool sto = stochastic != 0;
  if (task == TASK_HOVER && integrator == INTEG_EULER)
    return (int)launch_mode<TASK_HOVER, INTEG_EULER>(pf, pi, pl, lo, w, T, sto, s);
  if (task == TASK_HOVER && integrator == INTEG_RK4)
    return (int)launch_mode<TASK_HOVER, INTEG_RK4>(pf, pi, pl, lo, w, T, sto, s);
  if (task == TASK_WAYPOINT && integrator == INTEG_EULER)
    return (int)launch_mode<TASK_WAYPOINT, INTEG_EULER>(pf, pi, pl, lo, w, T, sto, s);
  if (task == TASK_WAYPOINT && integrator == INTEG_RK4)
    return (int)launch_mode<TASK_WAYPOINT, INTEG_RK4>(pf, pi, pl, lo, w, T, sto, s);
  if (task == TASK_RACING && integrator == INTEG_EULER)
    return (int)launch_mode<TASK_RACING, INTEG_EULER>(pf, pi, pl, lo, w, T, sto, s);
  if (task == TASK_RACING && integrator == INTEG_RK4)
    return (int)launch_mode<TASK_RACING, INTEG_RK4>(pf, pi, pl, lo, w, T, sto, s);
  return (int)cudaErrorInvalidValue;
}
