// acting_lstm.cu — the recurrent acting kernels: LSTM policy + env for T
// steps per lane. One kernel serves both:
//   K8 (serving): deterministic actions (the policy mean), episode stats and
//     the final carry. Replaces drone_tpu/ops/pallas_acting_lstm.py `_kernel`
//     (driven by `lstm_act_rollout_pallas`).
//   K6 (training rollout): exploration noise, the critic head, the 21
//     trajectory planes of K2 and the (c, h) anchor entering the first step
//     of every bptt segment. Replaces `_lstm_traj_kernel` (driven by
//     `traj_lstm_rollout_pallas`).
// Wrappers and plain versions: ops/cuda_acting_lstm.py.
//
// Design: a block of 256 threads owns a tile of 128 lanes (lstm.cuh): the
// encoder, the gate block and c live in shared memory as [row][lane]; the
// first 128 threads also own one lane each for the env (env.cuh's Carry in
// registers for the whole loop, as in K5 and K2), the heads, the noise and
// the plane stores. Per step: observe -> encoder -> gates -> heads -> (noise,
// log-prob, planes) -> env step -> zero the carry of lanes that ended an
// episode (ppo_rnn._mask_carry: c' * keep, h' * keep). The anchors are the
// carry after the previous step's mask. The carry comes in and goes out as
// (n, H) row-major tensors, the module's layout; the anchors are (S, 2, H,
// n) planes, what K7 reads.
//
// The CNN arm (pixel-recurrent cnn_lstm; the reference's encoder == "cnn"
// branches of both kernels), on tiles of 64 lanes: per step the lane
// threads store the 12 splat scalars of their observation, then the block
// runs the tower's forward on the tensor cores in 3xTF32, cnn_mma.cuh's
// tower_fwd_tile (K11's, and K10's and K7's), whose output x lands in the
// tile's rows, then the gate block on the tensor cores too (lstm_mma.cuh:
// each thread holds all four gates of its (lane, unit) pairs and updates
// their c), then the heads, env step and masks as the dense arm. The
// wrapper's call packs the tower's forward fragments (pack_tower_kernel)
// and the gate weights' (pack_gates_kernel) once, on the launch's stream.
// Shared memory: the tower's 109,952 bytes, then h and c at the tower's
// row stride (73,728 bytes at H 128): 183,680 bytes, one block an SM. The
// carry does not fit beside a second block's tower rows, and in registers
// it would take 64 a thread beside the tower's own; so the block's render
// overlaps only its own products (a patch's render beside the last
// patch's conv0). The dense arm keeps its 128 lanes and its code.
//
// What bounds it on an H100: the dense arm, the gate block's multiply-adds,
// 4H (E + H) per lane-step (98,304 at H 128 / E 64), on the fp32 cores; the
// env, the encoder and the heads are a few percent beside them, the planes
// 84 bytes a lane-step. The weights stream from L2 (lstm.cuh). The CNN arm,
// the tower's ~369k multiply-adds and the gate block's 131,072 (E 128) a
// lane-step at the 3xTF32 rate, the 2,304 expf of the render on the fp32
// cores, and the gate weights' 1 MB of fragments from L2 a tile-step.

#include <cuda_runtime.h>

#include <cstdint>

#include "env.cuh"
#include "lstm.cuh"
#include "lstm_mma.cuh"

namespace drone {

constexpr int ACT_LANES = 128;
// gate passes: (LSTM_MAX_H / 4) * (ACT_LANES / 4) tiles over LSTM_THREADS
constexpr int ACT_PASSES = (LSTM_MAX_H / 4) * (ACT_LANES / 4) / LSTM_THREADS;
// 2 input rows of gate weights in flight (at 4 the registers spill)
constexpr int ACT_UNROLL = 2;

struct LstmIO {
  const float* theta;  // flat parameters
  const float4* WP;    // packed gate weights (E + H, H, 4)
  const float4* BP;    // packed gate biases (H, 4)
  const float* c_in;   // (n, H)
  const float* h_in;
  float* c_out;
  float* h_out;
  float* traj;         // (T, 21, n), or null when serving
  float* snap;         // (T / bptt, 2, H, n), or null when serving
  int T, bptt, stochastic;
};

// The CNN arm's inputs (unused by the dense arm).
struct CnnIn {
  const float4* pk;   // the tower's forward fragments (cnn_mma.cuh PK_FWD)
  const float4* pg;   // the gate weights' fragments (lstm_mma.cuh)
  const float* grid;  // the pixel coordinates (2, 576)
};

// A block's dynamic shared memory. The CNN arm: the tower's forward tile,
// then h and c (gate_units(H) rows each at its stride).
inline size_t act_smem_bytes(const LstmNet& net, int encoder) {
  if (encoder == ENC_CNN)
    return (size_t)TF_SMEM +
           sizeof(float) * (size_t)TM_S * 2 * gate_units(net.H);
  int maxw, nbuf;
  enc_buffers(net, maxw, nbuf);
  return sizeof(float) * (size_t)ACT_LANES *
         (OBS_DIM + nbuf * maxw + net.E + 2 * net.H);
}

template <int TASK, int INTEG, int ENC>
__global__ void __launch_bounds__(LSTM_THREADS, 1)
lstm_act_kernel(const float* __restrict__ pf, const int* __restrict__ pi,
                Planes pl, LstmNet net, LstmIO io, CnnIn cn) {
  constexpr bool CNN = ENC == ENC_CNN;
  constexpr int L = CNN ? TM_L : ACT_LANES;
  // floats between the rows of h and c ([unit][lane]): the CNN arm's at
  // the tower's stride, as the gate product's A fragments read h
  constexpr int RS = CNN ? TM_S : ACT_LANES;
  extern __shared__ float4 smem4[];
  __shared__ EnvP P;
  const int H = net.H, E = net.E;
  // the rows of h and c (the CNN arm's padded to the gate block's units)
  const int HR = CNN ? gate_units(H) : H;
  // dense: the obs rows and the encoder's buffers before xh = (x; h), then
  // c; CNN: the tower's tile (x among its rows), then h and c
  float* const sm = reinterpret_cast<float*>(smem4);
  float *obs, *buf0, *buf1, *xh, *sp, *h, *c;
  if constexpr (CNN) {
    obs = buf0 = buf1 = xh = nullptr;
    sp = tf_rows(sm) + TF_SP * TM_S;
    h = sm + TF_SMEM / sizeof(float);
    c = h + HR * RS;
  } else {
    int maxw, nbuf;
    enc_buffers(net, maxw, nbuf);
    obs = sm;
    buf0 = obs + OBS_DIM * L;
    buf1 = buf0 + maxw * L;
    xh = buf0 + nbuf * maxw * L;
    sp = nullptr;
    h = xh + E * L;
    c = xh + (E + H) * L;
  }
  const int n = pl.n;
  const int lane0 = blockIdx.x * L;
  const int tid = threadIdx.x;

  // the last tile may be ragged: its lanes past n compute on zeros and
  // store nothing
  for (int e = tid; e < HR * L; e += blockDim.x) {
    const int l = e / HR, u = e % HR;
    const size_t g = (size_t)(lane0 + l) * H + u;
    const bool valid = lane0 + l < n && (!CNN || u < H);
    c[u * RS + l] = valid ? io.c_in[g] : 0.0f;
    h[u * RS + l] = valid ? io.h_in[g] : 0.0f;
  }
  if constexpr (CNN) tower_load_w0(sm, cn.pk);
  load_params(pf, pi, P);  // ends with the barrier the copies need

  const bool lane_thread = tid < L && lane0 + tid < n;
  const int i = lane0 + tid;
  Carry cr;
  if (lane_thread) cr = read_carry(pl, i);
  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float ls[4], stdv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ls[k] = io.theta[net.ls_off + k];
    stdv[k] = expf(ls[k]);
  }
  // with no encoder the obs are the LSTM's input rows
  float* obs_rows = net.n_enc ? obs : xh;

  for (int t = 0; t < io.T; ++t) {
    float* out = io.traj ? io.traj + (size_t)t * N_TRAJ * n + i : nullptr;
    if (io.snap && t % io.bptt == 0) {
      // the anchor: the carry entering this step, after the last mask
      float* s = io.snap + (size_t)(t / io.bptt) * 2 * H * n + lane0;
      for (int e = tid; e < H * L; e += blockDim.x) {
        const int u = e / L, l = e % L;
        if (lane0 + l >= n) continue;
        s[(size_t)u * n + l] = c[u * RS + l];
        s[(size_t)(H + u) * n + l] = h[u * RS + l];
      }
    }
    if constexpr (CNN) {
      // the splat scalars of the observation (zeros past n)
      if (tid < L) {
        float o[OBS_DIM], s12[12];
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
        splat12(o, s12);
#pragma unroll
        for (int k = 0; k < 12; ++k) sp[k * TM_S + tid] = s12[k];
      }
      __syncthreads();
      tower_fwd_tile(sm, io.theta, cn.pk, cn.grid, [](int, const float*) {});
      __syncthreads();
      lstm_gates_mma(tf_rows(sm) + TF_Y0 * TM_S, h, c, E, H, cn.pg, io.BP);
    } else {
      if (lane_thread) {
        float o[OBS_DIM];
        observe(cr, o);
#pragma unroll
        for (int k = 0; k < OBS_DIM; ++k) {
          obs_rows[k * L + tid] = o[k];
          if (out) out[(size_t)k * n] = o[k];
        }
      } else if (tid < L) {
#pragma unroll
        for (int k = 0; k < OBS_DIM; ++k) obs_rows[k * L + tid] = 0.0f;
      }
      __syncthreads();
      lstm_encoder<L>(obs, buf0, buf1, xh, io.theta, net, NoLayerOut{});
      lstm_gates<L, ACT_PASSES, ACT_UNROLL>(xh, c, E, H, io.WP, io.BP,
                                            NoGateOut{});
    }
    __syncthreads();
    if (lane_thread) {
      float m[4], v, a[4];
      lstm_heads(h, RS, tid, io.theta, net, m, v);
      if (out) {
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (io.stochastic) gauss4(cr.k0, cr.k1, cr.rc, cr.stp, z);
        float logp;
        sample_logp(m, z, ls, stdv, io.stochastic != 0, a, logp);
#pragma unroll
        for (int k = 0; k < 4; ++k) out[(size_t)(TP_ACT0 + k) * n] = a[k];
        out[(size_t)TP_LOGP * n] = logp;
        out[(size_t)TP_VAL * n] = v;
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
      // _mask_carry: this lane's column of c and h, owned by this thread
      const float keep = 1.0f - (done ? 1.0f : 0.0f);
      for (int u = 0; u < H; ++u) {
        c[u * RS + tid] = c[u * RS + tid] * keep;
        h[u * RS + tid] = h[u * RS + tid] * keep;
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < H * L; e += blockDim.x) {
    const int l = e / H, u = e % H;
    if (lane0 + l >= n) continue;
    const size_t g = (size_t)(lane0 + l) * H + u;
    io.c_out[g] = c[u * RS + l];
    io.h_out[g] = h[u * RS + l];
  }
  if (lane_thread) write_back(pl, i, cr, acc);
}

template <int TASK, int INTEG, int ENC>
cudaError_t launch_arm(const float* pf, const int* pi, const Planes& pl,
                       const LstmNet& net, const LstmIO& io, const CnnIn& cn,
                       cudaStream_t stream) {
  constexpr int L = ENC == ENC_CNN ? TM_L : ACT_LANES;
  const size_t smem = act_smem_bytes(net, ENC);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_act_kernel<TASK, INTEG, ENC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lstm_act_kernel<TASK, INTEG, ENC>
      <<<(pl.n + L - 1) / L, LSTM_THREADS, smem, stream>>>(pf, pi, pl, net,
                                                           io, cn);
  return cudaGetLastError();
}

template <int TASK, int INTEG>
cudaError_t launch(const float* pf, const int* pi, const Planes& pl,
                   const LstmNet& net, const LstmIO& io, const CnnIn& cn,
                   int encoder, cudaStream_t stream) {
  if (encoder == ENC_CNN)
    return launch_arm<TASK, INTEG, ENC_CNN>(pf, pi, pl, net, io, cn, stream);
  return launch_arm<TASK, INTEG, ENC_DENSE>(pf, pi, pl, net, io, cn, stream);
}

}  // namespace drone

// C interface (ctypes). pf/pi: device env params; fs..stats: the state and
// statistic planes of rollout.cu; theta: the flat parameters; wp/bp: the
// packed gate weights (E + H, H, 4) and biases (H, 4); c_in/h_in and
// c_out/h_out: the carry, (n, H) each; traj/snap: the trajectory planes
// and the anchors, both null to serve (K8) or both set to train (K6);
// pk/pg/grid: the CNN arm's room for the tower's forward fragments
// (PK_FWD float4s) and the gate weights' (gate_frags(E, H) float4s),
// written here on the stream before the kernel reads them, and the pixel
// coordinates (else null). layout: host ints (lstm.cuh NET_INTS); encoder:
// ENC_DENSE or ENC_CNN; smem: the block's shared bytes as the wrapper
// counts them (refused unless act_smem_bytes').
extern "C" int drone_lstm_act_rollout(
    const float* pf, const int* pi, const float* fs, const uint32_t* us,
    const int* st, float* ofs, uint32_t* ous, int* ost, float* stats,
    const float* theta, const float* wp, const float* bp, const float* c_in,
    const float* h_in, float* c_out, float* h_out, float* traj, float* snap,
    float* pk, float* pg, const float* grid, const int* layout, int encoder,
    int stochastic, int bptt, int smem, int n, int T, int task,
    int integrator, void* stream) {
  using namespace drone;
  LstmNet net;
  if (!read_net(layout, encoder, net) || n <= 0 || T < 0 ||
      (traj == nullptr) != (snap == nullptr) ||
      (snap != nullptr && (bptt <= 0 || T % bptt != 0)) ||
      (size_t)smem != act_smem_bytes(net, encoder) ||
      (encoder == ENC_CNN &&
       (pk == nullptr || pg == nullptr || grid == nullptr)))
    return (int)cudaErrorInvalidValue;
  const LstmIO io{theta, reinterpret_cast<const float4*>(wp),
                  reinterpret_cast<const float4*>(bp), c_in, h_in, c_out,
                  h_out, traj, snap, T, bptt > 0 ? bptt : 1, stochastic};
  const Planes pl{fs, us, st, ofs, ous, ost, stats, n};
  float4* pk4 = reinterpret_cast<float4*>(pk);
  float4* pg4 = reinterpret_cast<float4*>(pg);
  const CnnIn cn{pk4, pg4, grid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (encoder == ENC_CNN) {
    const int nf = gate_frags(net.E, net.H);
    pack_tower_kernel<<<(PK_FWD + 255) / 256, 256, 0, s>>>(theta, pk4, PK_FWD);
    pack_gates_kernel<<<(nf + 255) / 256, 256, 0, s>>>(wp, net.E, net.H, pg4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
#define DRONE_LSTM_CASE(TK, IG)                                             \
  if (task == TK && integrator == IG)                                       \
    return (int)launch<TK, IG>(pf, pi, pl, net, io, cn, encoder, s);
  DRONE_LSTM_CASE(TASK_HOVER, INTEG_EULER)
  DRONE_LSTM_CASE(TASK_HOVER, INTEG_RK4)
  DRONE_LSTM_CASE(TASK_WAYPOINT, INTEG_EULER)
  DRONE_LSTM_CASE(TASK_WAYPOINT, INTEG_RK4)
  DRONE_LSTM_CASE(TASK_RACING, INTEG_EULER)
  DRONE_LSTM_CASE(TASK_RACING, INTEG_RK4)
#undef DRONE_LSTM_CASE
  return (int)cudaErrorInvalidValue;
}
