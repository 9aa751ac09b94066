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
// Design: a block of 256 threads owns a tile of 64 lanes (TM_L): the
// encoder's rows, the gate block's input rows x, h and c live in shared
// memory as [row][lane] at the tensor-core tiles' stride TM_S (72: an A
// fragment's 32 reads hit 32 banks); the first 64 threads also own one lane
// each for the env (env.cuh's Carry in registers for the whole loop, as in
// K5 and K2), the heads, the noise and the plane stores. Per step: observe
// -> encoder -> gates -> heads -> (noise, log-prob, planes) -> env step ->
// zero the carry of lanes that ended an episode (ppo_rnn._mask_carry: c' *
// keep, h' * keep). The anchors are the carry after the previous step's
// mask. The carry comes in and goes out as (n, H) row-major tensors, the
// module's layout; the anchors are (S, 2, H, n) planes, what K7 reads.
//
// The gate block runs on the tensor cores in 3xTF32 in both arms
// (lstm_mma.cuh lstm_gates_mma: each thread holds all four gates of its
// (lane, unit) pairs and updates their c), from fragments the call packs
// once on the launch's stream (pack_gates_kernel). The dense arm's tanh
// encoder stays on the fp32 cores (lstm.cuh dense_tanh, 4 (13 + ...)
// multiply-adds a unit against the gates' 4 (E + H)). Shared memory: the
// obs, the encoder's buffers, x (E padded to 8 with zero rows), h, c, the
// heads' 5 rows and keep's (act_smem_bytes): 97,632 bytes at H 128 / E 64,
// one block an SM (the gate block's
// accumulators and h' take ~150 registers a thread, past the 128 of two
// blocks).
//
// The CNN arm (pixel-recurrent cnn_lstm; the reference's encoder == "cnn"
// branches of both kernels): per step the lane threads store the 12 splat
// scalars of their observation, then the block runs the tower's forward on
// the tensor cores in 3xTF32, cnn_mma.cuh's tower_fwd_tile (K11's, and
// K10's and K7's), whose output x lands in the tile's rows, then the gate
// block; the call also packs the tower's forward fragments
// (pack_tower_kernel). Shared memory: the tower's 109,952 bytes, then h, c,
// the heads' and keep's rows (75,456 bytes at H 128): 185,408 bytes, one
// block an SM. The carry does
// not fit beside a second block's tower rows, and in registers it would take
// 64 a thread beside the tower's own; so the block's render overlaps only
// its own products (a patch's render beside the last patch's conv0).
//
// What bounds it on an H100: the gate block's 4 Hp (Ep + Hp) multiply-adds
// a lane-step (98,304 at H 128 / E 64; 131,072 at the CNN arm's E 128) at
// the 3xTF32 rate, and its fragments from L2, 786,432 bytes a tile-step at
// H 128 / E 64 (12,288 a lane-step); the env, the dense encoder and the
// heads on the fp32 cores are a few percent beside them, the planes 84
// bytes a lane-step. The CNN arm adds the tower's ~369k multiply-adds a
// lane-step at the 3xTF32 rate and the render's 2,304 expf on the fp32
// cores.

#include <cuda_runtime.h>

#include <cstdint>

#include "env.cuh"
#include "lstm.cuh"
#include "lstm_mma.cuh"

namespace drone {

struct LstmIO {
  const float* theta;  // flat parameters
  const float4* BP;    // packed gate biases (H, 4)
  const float* c_in;   // (n, H)
  const float* h_in;
  float* c_out;
  float* h_out;
  float* traj;         // (T, 21, n), or null when serving
  float* snap;         // (T / bptt, 2, H, n), or null when serving
  int T, bptt, stochastic;
};

// The packed fragments: the gate weights' (both arms) and the CNN arm's
// tower and pixel grid.
struct Frags {
  const float4* pg;   // the gate weights' fragments (lstm_mma.cuh)
  const float4* pk;   // the tower's forward fragments (cnn_mma.cuh PK_FWD)
  const float* grid;  // the pixel coordinates (2, 576)
};

// A block's dynamic shared memory, rows of the tile at stride TM_S. The
// dense arm: the obs, the encoder's buffers, x (Ep rows), h and c (Hp rows
// each); the CNN arm: the tower's forward tile, then h and c; both then the
// heads' m and v (5 rows) and keep (1).
inline size_t act_smem_bytes(const LstmNet& net, int encoder) {
  const size_t hc = 2 * (size_t)gate_units(net.H) + 6;
  if (encoder == ENC_CNN) return TF_SMEM + sizeof(float) * TM_S * hc;
  int maxw, nbuf;
  enc_buffers(net, maxw, nbuf);
  return sizeof(float) * TM_S *
         (OBS_DIM + (size_t)nbuf * maxw + gate_inputs(net.E) + hc);
}

template <int TASK, int INTEG, int ENC>
__global__ void __launch_bounds__(LSTM_THREADS, 1)
lstm_act_kernel(const float* __restrict__ pf, const int* __restrict__ pi,
                Planes pl, LstmNet net, LstmIO io, Frags fr) {
  constexpr bool CNN = ENC == ENC_CNN;
  constexpr int L = TM_L, S = TM_S;
  extern __shared__ float4 smem4[];
  __shared__ EnvP P;
  const int H = net.H, E = net.E;
  const int Hp = gate_units(H), Ep = gate_inputs(E);
  // dense: the obs rows and the encoder's buffers before x, then h and c;
  // CNN: the tower's tile (x among its rows), then h and c
  float* const sm = reinterpret_cast<float*>(smem4);
  float *obs, *buf0, *buf1, *x, *sp, *h;
  if constexpr (CNN) {
    obs = buf0 = buf1 = nullptr;
    sp = tf_rows(sm) + TF_SP * S;
    x = tf_rows(sm) + TF_Y0 * S;
    h = sm + TF_SMEM / sizeof(float);
  } else {
    int maxw, nbuf;
    enc_buffers(net, maxw, nbuf);
    obs = sm;
    buf0 = obs + OBS_DIM * S;
    buf1 = buf0 + maxw * S;
    x = buf0 + nbuf * maxw * S;
    sp = nullptr;
    h = x + Ep * S;
  }
  float* const c = h + Hp * S;
  float* const mv = c + Hp * S;     // the heads' m and v (5 rows)
  float* const keep_s = mv + 5 * S;  // the step's keep (1 row)
  const int n = pl.n;
  const int lane0 = blockIdx.x * L;
  const int tid = threadIdx.x;

  // the last tile may be ragged: its lanes past n compute on zeros and
  // store nothing
  for (int e = tid; e < Hp * L; e += blockDim.x) {
    const int l = e / Hp, u = e % Hp;
    const size_t g = (size_t)(lane0 + l) * H + u;
    const bool valid = lane0 + l < n && u < H;
    c[u * S + l] = valid ? io.c_in[g] : 0.0f;
    h[u * S + l] = valid ? io.h_in[g] : 0.0f;
  }
  if constexpr (CNN) {
    tower_load_w0(sm, fr.pk);
  } else {
    for (int e = tid; e < (Ep - E) * L; e += blockDim.x)
      x[(E + e / L) * S + e % L] = 0.0f;  // x's padded rows
  }
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
  float* obs_rows = net.n_enc ? obs : x;

  for (int t = 0; t < io.T; ++t) {
    float* out = io.traj ? io.traj + (size_t)t * N_TRAJ * n + i : nullptr;
    if (io.snap && t % io.bptt == 0) {
      // the anchor: the carry entering this step, after the last mask
      float* s = io.snap + (size_t)(t / io.bptt) * 2 * H * n + lane0;
      for (int e = tid; e < H * L; e += blockDim.x) {
        const int u = e / L, l = e % L;
        if (lane0 + l >= n) continue;
        s[(size_t)u * n + l] = c[u * S + l];
        s[(size_t)(H + u) * n + l] = h[u * S + l];
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
        for (int k = 0; k < 12; ++k) sp[k * S + tid] = s12[k];
      }
      __syncthreads();
      tower_fwd_tile(sm, io.theta, fr.pk, fr.grid, [](int, const float*) {});
      __syncthreads();
    } else {
      if (lane_thread) {
        float o[OBS_DIM];
        observe(cr, o);
#pragma unroll
        for (int k = 0; k < OBS_DIM; ++k) {
          obs_rows[k * S + tid] = o[k];
          if (out) out[(size_t)k * n] = o[k];
        }
      } else if (tid < L) {
#pragma unroll
        for (int k = 0; k < OBS_DIM; ++k) obs_rows[k * S + tid] = 0.0f;
      }
      __syncthreads();
      lstm_encoder<L, S, S>(obs, buf0, buf1, x, io.theta, net, NoLayerOut{});
    }
    lstm_gates_mma(x, h, E, H, fr.pg, io.BP, SharedCell{c});
    __syncthreads();
    {
      float m[4], v;
      lstm_heads4(h, S, io.theta, net, m, v);
      if ((tid & 3) == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) mv[k * S + tid / 4] = m[k];
        mv[4 * S + tid / 4] = v;
      }
    }
    __syncthreads();
    if (lane_thread) {
      float m[4], a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) m[k] = mv[k * S + tid];
      if (out) {
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (io.stochastic) gauss4(cr.k0, cr.k1, cr.rc, cr.stp, z);
        float logp;
        sample_logp(m, z, ls, stdv, io.stochastic != 0, a, logp);
#pragma unroll
        for (int k = 0; k < 4; ++k) out[(size_t)(TP_ACT0 + k) * n] = a[k];
        out[(size_t)TP_LOGP * n] = logp;
        out[(size_t)TP_VAL * n] = mv[4 * S + tid];
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
      keep_s[tid] = 1.0f - (done ? 1.0f : 0.0f);
    } else if (tid < L) {
      keep_s[tid] = 1.0f;  // a lane past n: nothing of it is stored
    }
    __syncthreads();
    // _mask_carry: c and h of the lanes that ended an episode
    for (int e = tid; e < H * L; e += blockDim.x) {
      const int u = e / L, l = e % L;
      c[u * S + l] = c[u * S + l] * keep_s[l];
      h[u * S + l] = h[u * S + l] * keep_s[l];
    }
    __syncthreads();
  }

  for (int e = tid; e < H * L; e += blockDim.x) {
    const int l = e / H, u = e % H;
    if (lane0 + l >= n) continue;
    const size_t g = (size_t)(lane0 + l) * H + u;
    io.c_out[g] = c[u * S + l];
    io.h_out[g] = h[u * S + l];
  }
  if (lane_thread) write_back(pl, i, cr, acc);
}

template <int TASK, int INTEG, int ENC>
cudaError_t launch_arm(const float* pf, const int* pi, const Planes& pl,
                       const LstmNet& net, const LstmIO& io, const Frags& fr,
                       cudaStream_t stream) {
  const size_t smem = act_smem_bytes(net, ENC);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_act_kernel<TASK, INTEG, ENC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  lstm_act_kernel<TASK, INTEG, ENC>
      <<<(pl.n + TM_L - 1) / TM_L, LSTM_THREADS, smem, stream>>>(
          pf, pi, pl, net, io, fr);
  return cudaGetLastError();
}

template <int TASK, int INTEG>
cudaError_t launch(const float* pf, const int* pi, const Planes& pl,
                   const LstmNet& net, const LstmIO& io, const Frags& fr,
                   int encoder, cudaStream_t stream) {
  if (encoder == ENC_CNN)
    return launch_arm<TASK, INTEG, ENC_CNN>(pf, pi, pl, net, io, fr, stream);
  return launch_arm<TASK, INTEG, ENC_DENSE>(pf, pi, pl, net, io, fr, stream);
}

}  // namespace drone

// C interface (ctypes). pf/pi: device env params; fs..stats: the state and
// statistic planes of rollout.cu; theta: the flat parameters; wp/bp: the
// gate weights (E + H, H, 4) and biases (H, 4); c_in/h_in and c_out/h_out:
// the carry, (n, H) each; traj/snap: the trajectory planes and the anchors,
// both null to serve (K8) or both set to train (K6); pg: room for the gate
// weights' fragments (gate_frags(E, H) float4s); pk/grid: the CNN arm's
// room for the tower's forward fragments (PK_FWD float4s) and the pixel
// coordinates (else null). The fragments are written here on the stream
// before the kernel reads them. layout: host ints (lstm.cuh NET_INTS);
// encoder: ENC_DENSE or ENC_CNN; smem: the block's shared bytes as the
// wrapper counts them (refused unless act_smem_bytes').
extern "C" int drone_lstm_act_rollout(
    const float* pf, const int* pi, const float* fs, const uint32_t* us,
    const int* st, float* ofs, uint32_t* ous, int* ost, float* stats,
    const float* theta, const float* wp, const float* bp, const float* c_in,
    const float* h_in, float* c_out, float* h_out, float* traj, float* snap,
    float* pg, float* pk, const float* grid, const int* layout, int encoder,
    int stochastic, int bptt, int smem, int n, int T, int task,
    int integrator, void* stream) {
  using namespace drone;
  LstmNet net;
  if (!read_net(layout, encoder, net) || n <= 0 || T < 0 ||
      (traj == nullptr) != (snap == nullptr) ||
      (snap != nullptr && (bptt <= 0 || T % bptt != 0)) ||
      (size_t)smem != act_smem_bytes(net, encoder) || pg == nullptr ||
      (encoder == ENC_CNN && (pk == nullptr || grid == nullptr)))
    return (int)cudaErrorInvalidValue;
  const LstmIO io{theta, reinterpret_cast<const float4*>(bp), c_in, h_in,
                  c_out, h_out, traj, snap, T, bptt > 0 ? bptt : 1,
                  stochastic};
  const Planes pl{fs, us, st, ofs, ous, ost, stats, n};
  float4* pg4 = reinterpret_cast<float4*>(pg);
  float4* pk4 = reinterpret_cast<float4*>(pk);
  const Frags fr{pg4, pk4, grid};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nf = gate_frags(net.E, net.H);
  pack_gates_kernel<<<(nf + 255) / 256, 256, 0, s>>>(wp, net.E, net.H, pg4);
  if (encoder == ENC_CNN)
    pack_tower_kernel<false><<<(PK_FWD + 255) / 256, 256, 0, s>>>(theta, pk4,
                                                                  PK_FWD);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
#define DRONE_LSTM_CASE(TK, IG)                                             \
  if (task == TK && integrator == IG)                                       \
    return (int)launch<TK, IG>(pf, pi, pl, net, io, fr, encoder, s);
  DRONE_LSTM_CASE(TASK_HOVER, INTEG_EULER)
  DRONE_LSTM_CASE(TASK_HOVER, INTEG_RK4)
  DRONE_LSTM_CASE(TASK_WAYPOINT, INTEG_EULER)
  DRONE_LSTM_CASE(TASK_WAYPOINT, INTEG_RK4)
  DRONE_LSTM_CASE(TASK_RACING, INTEG_EULER)
  DRONE_LSTM_CASE(TASK_RACING, INTEG_RK4)
#undef DRONE_LSTM_CASE
  return (int)cudaErrorInvalidValue;
}
