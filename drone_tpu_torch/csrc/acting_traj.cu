// acting_traj.cu — the trajectory rollout kernel (K2): actor + critic +
// exploration noise + env step for T steps per lane, streaming the PPO
// training planes.
//
// Replaces drone_tpu/ops/pallas_acting_traj.py `_traj_kernel` (driven by
// `traj_act_rollout_pallas_planes`; the megakernel trainer's rollout).
// Wrapper and plain version: ops/cuda_acting_traj.py.
//
// Design: one thread per lane runs the observation, the Box-Muller draw
// (policy.cuh gauss4), the log-prob of the stored action (sample_logp),
// the env step (env.cuh) and the plane stores; the lanes of a warp
// evaluate both towers together before each step, one product per layer
// on the tensor cores (mma.sync m16n8k8 in 3xTF32, tower_mma.cuh, as K5):
// M = the warp's 32 lanes, K and N the layers padded to 8 (the 13 obs to
// 16), an IEEE add a k-step (H10). Per lane-step it writes the 21 planes
// obs(13) act(4) logp value reward done in the reference's TP_* order,
// time-major as (T, 21, n): thread i writes lane i, so every store of a
// warp is one coalesced 128-byte run. std = expf(log_std) is computed here
// from the parameter buffer: a launch needs no host copy of it.
//
// A step: the lanes write their obs into the warp's columns of the obs
// rows, and the actor, then the critic, runs over them: each hidden layer
// but the last writes tanh of its products into the next rows (ping-pong
// at depth 3 and more); the last hidden layer runs TRAJ_FOLD_NT n-tiles at
// a time and each chunk's tanh, still in the accumulators, goes into the
// head at once (regs_mma: the accumulators of a tile are an A fragment in
// the order the head's fragments are packed), so the obs rows stay intact
// for the critic and the last hidden layer needs no rows. Both heads share
// one n-tile: the actor's 4 means are its columns 0-3, the critic's value
// column 4. Each thread reads its lane's 5 back. Only __syncwarp orders a
// step's layers: no block barrier inside the step loop. Lanes past n take
// part in the products with zero obs and store nothing; a warp with no
// lane to step returns.
//
// Weights: the trainer's flat parameter buffer (the reference's
// _kernel_tensors order: per layer W (out, in) then b, actor then critic,
// then log_std), which K4 rewrites on the device after every SGD step, is
// split on the launch's stream by pack_traj_kernel into (big, small)
// fragments in a warp's read order (tower_mma.cuh; the heads in pair
// order), then the padded biases, in a buffer the wrapper allocates: no
// host copy and no sync. Each block stages the biases and, where they fit
// beside its lanes (ops/cuda_acting_traj.py traj_layout), both towers'
// fragments in shared memory; else the fragments are read through L1 from
// L2.
//
// The bf16 arm (compute_dtype="bfloat16", the reference's bf16 operand
// arm of _traj_kernel: _tower's _dot32 rounds both operands of every
// product): the BF16 template parameter, on the bf16 tensor cores
// (tower_mma.cuh's _b16 forms, m16n8k16). The warp's rows are stored once
// as bf16 (the obs by its store, each stored hidden layer by
// store_tanh_b16), read by ldmatrix; pack_traj_b16_kernel packs the
// weights as bf16x2 fragments (a uint2 a lane a 16 x 8 tile), staged in
// shared memory where they fit (traj_layout's rule, half the rows' bytes);
// the last hidden layer feeds the head from its accumulators, two bf16x2
// packs a register. Each k-step of 16 joins its sum by an IEEE add (H10).
// The biases, the tanh and everything after the heads stay fp32 (the
// heads' outputs pass through the obs rows as floats).
//
// What bounds it on an H100: both towers' products (10,368 multiply-adds
// a lane-step at [64, 64]) at the 3xTF32 rate (the bf16 arm: at the bf16
// rate) beside the env step and the 256 tanhf a lane-step; its 21 planes
// are 84 bytes per lane-step, far below the memory rate. What holds it,
// as K5: the mma.sync TF32 rate, the operands' split and the tanhf on the
// CUDA cores (the bf16 arm: the tanhf and the env step).

#include <cuda_runtime.h>

#include <cstdint>

#include "env.cuh"
#include "policy.cuh"
#include "tower_mma.cuh"

namespace drone {

constexpr int TRAJ_MAX_LANES = 512;
constexpr int TRAJ_MAX_SMEM = 232448 - 256;  // less the env params' copy
constexpr int TRAJ_VALUE_COL = 4;            // the value's head column
constexpr int TRAJ_HEAD_OUT = 5;             // 4 means and the value
constexpr int TRAJ_NT = 4;       // n-tiles of a product of a stored layer
constexpr int TRAJ_FOLD_NT = 2;  // n-tiles of a fold chunk

// The layout (ops/cuda_acting_traj.py traj_layout mirrors it). The packed
// buffer: the actor's fragments (f4 float4s), the critic's, then each
// tower's padded biases (nb floats); wfl floats in all. Shared memory:
// log_std and std (8 floats), both towers' biases, padded to hf floats;
// both towers' fragments when staged (wsm 1); then the activation rows
// (obs, ping, pong; `rows` of `as` floats). ly: a tower's layers, offsets
// relative to its own fragments and biases; the head has 8 outputs (one
// n-tile), the value at column TRAJ_VALUE_COL.
struct TLayout {
  int L, bl, as, wsm;
  int f4, nb, wfl, hf;
  int ha, hb, rows;
  ALayer ly[MAX_HIDDEN + 1];
};

// Where each tower's layers start in the flat buffer: W (out, in) of layer
// l (hidden layers, then the head) at w[tower][l], its bias right after.
struct TSrc {
  int w[2][MAX_HIDDEN + 1];
  int ls;
};

// bf16 (the bf16 arm): the fragments are uint2s, fo counts them, f4 the
// 16-byte units a tower's take; each stored layer's rows are padded to 16
// (bf16 rows, half the bytes).
inline void make_traj_layout(int L, const int* width, int bl, int wsm,
                             bool bf16, TLayout& lo) {
  lo.L = L;
  lo.bl = bl;
  lo.as = bl + 8;
  lo.wsm = wsm;
  int fo = 0, bo = 0, nin = OBS_DIM, mw = 0;
  for (int l = 0; l <= L; ++l) {
    ALayer& y = lo.ly[l];
    y.nin = nin;
    y.nout = l < L ? width[l] : 8;
    y.fo = fo;
    y.bo = bo;
    // a float4 holds 2 of B; a uint2 4 (bf16)
    fo += bf16 ? act_up16(nin) * act_up8(y.nout) / 4
               : act_up8(nin) * act_up8(y.nout) / 2;
    bo += act_up8(y.nout);
    const int rw = bf16 ? act_up16(y.nout) : act_up8(y.nout);
    if (l + 2 <= L && rw > mw) mw = rw;
    nin = y.nout;
  }
  lo.f4 = bf16 ? fo / 2 : fo;
  lo.nb = bo;
  lo.wfl = (8 * lo.f4 + 2 * bo + 3) & ~3;
  lo.hf = (8 + 2 * bo + 3) & ~3;
  lo.ha = TOWER_OBS_ROWS;
  lo.hb = lo.ha + (L >= 3 ? mw : 0);
  lo.rows = TOWER_OBS_ROWS + (L >= 2 ? mw : 0) + (L >= 3 ? mw : 0);
}

// Dynamic shared memory of a block (bf16: its rows are bf16).
inline size_t traj_smem(const TLayout& lo, bool bf16) {
  return sizeof(float) * ((size_t)lo.hf + (size_t)lo.wsm * 8 * lo.f4) +
         (bf16 ? 2 : 4) * (size_t)lo.rows * lo.as;
}

// The packed buffer from the flat one: thread e < 2 f4 writes float4 e of
// the fragments (tower e / f4), the next 2 nb threads a bias each. A head
// after hidden layers is packed in pair order (regs_mma), the linear
// policy's (L = 0) in the read order of warp_mma; the critic's value sits
// in column TRAJ_VALUE_COL. Padding is zero.
__global__ void pack_traj_kernel(const float* __restrict__ theta, TLayout lo,
                                 TSrc src, float4* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nfrag = 2 * lo.f4;
  const bool frag = e < nfrag;
  const int q = frag ? e : e - nfrag;
  const int per = frag ? lo.f4 : lo.nb;
  if (!frag && q >= 2 * lo.nb) return;
  const int tw = q / per, p = q % per;
  int l = 0;
  while (l < lo.L && p >= (frag ? lo.ly[l + 1].fo : lo.ly[l + 1].bo)) ++l;
  const ALayer& y = lo.ly[l];
  const bool head = l == lo.L;
  const int nout = head ? (tw ? 1 : 4) : y.nout;
  const int hc = head && tw ? TRAJ_VALUE_COL : 0;
  const float* W = theta + src.w[tw][l];
  if (!frag) {
    const int o = p - y.bo - hc;
    reinterpret_cast<float*>(out)[4 * nfrag + q] =
        o >= 0 && o < nout ? W[nout * y.nin + o] : 0.0f;
    return;
  }
  const int f = p - y.fo, NT = act_up8(y.nout) / 8;
  const int kt = (f >> 5) / NT, nt = (f >> 5) % NT;
  const int g = (f & 31) >> 2, t = f & 3;
  const bool pair = head && lo.L > 0;
  const int k0 = pair ? 8 * kt + 2 * t : 8 * kt + t;
  const int k1 = pair ? k0 + 1 : k0 + 4;
  const int o = 8 * nt + g - hc;
  float v0 = 0.0f, v1 = 0.0f;
  if (o >= 0 && o < nout) {
    if (k0 < y.nin) v0 = W[o * y.nin + k0];
    if (k1 < y.nin) v1 = W[o * y.nin + k1];
  }
  uint32_t b0, s0, b1, s1;
  split_tf32(v0, b0, s0);
  split_tf32(v1, b1, s1);
  out[e] = make_float4(__uint_as_float(b0), __uint_as_float(b1),
                       __uint_as_float(s0), __uint_as_float(s1));
}

// The bf16 arm's packed buffer (make_traj_layout with bf16): thread e < 4
// f4 writes uint2 e of the fragments (tower e / (2 f4); tower_mma.cuh's
// m16n8k16 B, W^T rounded to bf16, every layer the head too in that order),
// the next 2 nb threads a bias each (at float 8 f4, as the fp32 arm's).
__global__ void pack_traj_b16_kernel(const float* __restrict__ theta,
                                     TLayout lo, TSrc src,
                                     uint2* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nfrag = 4 * lo.f4;
  const bool frag = e < nfrag;
  const int q = frag ? e : e - nfrag;
  const int per = frag ? 2 * lo.f4 : lo.nb;
  if (!frag && q >= 2 * lo.nb) return;
  const int tw = q / per, p = q % per;
  int l = 0;
  while (l < lo.L && p >= (frag ? lo.ly[l + 1].fo : lo.ly[l + 1].bo)) ++l;
  const ALayer& y = lo.ly[l];
  const bool head = l == lo.L;
  const int nout = head ? (tw ? 1 : 4) : y.nout;
  const int hc = head && tw ? TRAJ_VALUE_COL : 0;
  const float* W = theta + src.w[tw][l];
  if (!frag) {
    const int o = p - y.bo - hc;
    reinterpret_cast<float*>(out)[2 * nfrag + q] =
        o >= 0 && o < nout ? W[nout * y.nin + o] : 0.0f;
    return;
  }
  const int f = p - y.fo, NT = act_up8(y.nout) / 8;
  const int kt = (f >> 5) / NT, nt = (f >> 5) % NT;
  const int g = (f & 31) >> 2, t = f & 3;
  const int k = 16 * kt + 2 * t, o = 8 * nt + g - hc;
  auto w = [&](int kk) {
    return o >= 0 && o < nout && kk < y.nin ? W[o * y.nin + kk] : 0.0f;
  };
  out[e] = make_uint2(bf16x2(w(k), w(k + 1)), bf16x2(w(k + 8), w(k + 9)));
}

// One tower for the warp's 32 lanes, the obs rows written (then a
// __syncwarp): hacc += its head's products. act: the warp's first column
// of the rows. Ends with a __syncwarp: its rows are read.
__device__ __forceinline__ void traj_tower(const TLayout& lo, const float4* W,
                                           const float* bias, float* act,
                                           float (&hacc)[2][1][4]) {
  const int as = lo.as, L = lo.L;
  const ALayer& hd = lo.ly[L];
  int in_row = 0;
  for (int l = 0; l + 1 < L; ++l) {  // the layers before the last hidden
    const ALayer& y = lo.ly[l];
    const int out_row = (l & 1) ? lo.hb : lo.ha, NT = act_up8(y.nout) / 8;
    for (int nt0 = 0; nt0 < NT; nt0 += TRAJ_NT) {
      const int nv = min(TRAJ_NT, NT - nt0);
      float acc[2][TRAJ_NT][4];
      zero_frags(acc);
      warp_mma<TRAJ_NT>(act + in_row * as, as, act_up8(y.nin), W + y.fo, NT,
                        nt0, nv, acc);
      store_tanh(acc, nv, nt0, out_row + 8 * nt0, bias + y.bo, act, as);
    }
    __syncwarp();
    in_row = out_row;
  }
  if (L > 0) {  // the last hidden layer, folded into the head by chunks
    const ALayer& y = lo.ly[L - 1];
    const int NT = act_up8(y.nout) / 8;
    for (int nt0 = 0; nt0 < NT; nt0 += TRAJ_FOLD_NT) {
      const int nv = min(TRAJ_FOLD_NT, NT - nt0);
      float acc[2][TRAJ_FOLD_NT][4];
      zero_frags(acc);
      warp_mma<TRAJ_FOLD_NT>(act + in_row * as, as, act_up8(y.nin),
                             W + y.fo, NT, nt0, nv, acc);
      tanh_regs(acc, nv, nt0, bias + y.bo);
      regs_mma<TRAJ_FOLD_NT>(acc, nv, W + hd.fo + nt0 * 32, hacc);
    }
  } else {
    warp_mma<1>(act, as, TOWER_OBS_ROWS, W + hd.fo, 1, 0, 1, hacc);
  }
  __syncwarp();
}

// traj_tower's bf16 arm: bf16 rows (act), m16n8k16 fragments (W, uint2s);
// each stored layer's K padded to 16, the last hidden layer folded into
// the head a k-tile of 16 (TRAJ_FOLD_NT n-tiles) at a time.
__device__ __forceinline__ void traj_tower_b16(const TLayout& lo,
                                               const uint2* W,
                                               const float* bias,
                                               uint16_t* act,
                                               float (&hacc)[2][1][4]) {
  static_assert(TRAJ_FOLD_NT == 2, "a fold chunk is one k-tile of 16");
  const int as = lo.as, L = lo.L;
  const ALayer& hd = lo.ly[L];
  int in_row = 0;
  for (int l = 0; l + 1 < L; ++l) {  // the layers before the last hidden
    const ALayer& y = lo.ly[l];
    const int out_row = (l & 1) ? lo.hb : lo.ha, NT = act_up8(y.nout) / 8;
    for (int nt0 = 0; nt0 < NT; nt0 += TRAJ_NT) {
      const int nv = min(TRAJ_NT, NT - nt0);
      float acc[2][TRAJ_NT][4];
      zero_frags(acc);
      warp_mma_b16<TRAJ_NT>(act + in_row * as, as, act_up16(y.nin), W + y.fo,
                            NT, nt0, nv, acc);
      store_tanh_b16(acc, nv, nt0, out_row + 8 * nt0, bias + y.bo, act, as);
    }
    __syncwarp();
    in_row = out_row;
  }
  if (L > 0) {  // the last hidden layer, folded into the head by chunks
    const ALayer& y = lo.ly[L - 1];
    const int NT = act_up8(y.nout) / 8;
    for (int nt0 = 0; nt0 < NT; nt0 += TRAJ_FOLD_NT) {
      const int nv = min(TRAJ_FOLD_NT, NT - nt0);
      float acc[2][TRAJ_FOLD_NT][4];
      zero_frags(acc);
      warp_mma_b16<TRAJ_FOLD_NT>(act + in_row * as, as, act_up16(y.nin),
                                 W + y.fo, NT, nt0, nv, acc);
      tanh_regs(acc, nv, nt0, bias + y.bo);
      regs_mma_b16(acc, nv, W + hd.fo + nt0 / 2 * 32, hacc);
    }
  } else {
    warp_mma_b16<1>(act, as, TOWER_OBS_ROWS, W + hd.fo, 1, 0, 1, hacc);
  }
  __syncwarp();
}

template <int TASK, int INTEG, bool STOCH, bool BF16>
__global__ void __launch_bounds__(TRAJ_MAX_LANES, 1)
traj_kernel(const float* __restrict__ pf, const int* __restrict__ pi,
            Planes pl, float* __restrict__ traj, TLayout lo,
            const float4* __restrict__ packed,
            const float* __restrict__ theta, int ls_off, int T) {
  extern __shared__ float4 smem4[];
  __shared__ EnvP P;
  float* sm = reinterpret_cast<float*>(smem4);
  const float* gb = reinterpret_cast<const float*>(packed + 2 * lo.f4);
  for (int k = threadIdx.x; k < 2 * lo.nb; k += blockDim.x) sm[8 + k] = gb[k];
  if (threadIdx.x < 4) {
    const float ls = theta[ls_off + threadIdx.x];
    sm[threadIdx.x] = ls;
    sm[4 + threadIdx.x] = expf(ls);
  }
  float4* staged = smem4 + lo.hf / 4;
  for (int k = threadIdx.x; k < lo.wsm * 2 * lo.f4; k += blockDim.x)
    staged[k] = packed[k];
  const float4* W = lo.wsm ? staged : packed;  // the actor's, the critic's
  const float* ba = sm + 8;
  const int lane = threadIdx.x & 31;
  float* act = sm + lo.hf + lo.wsm * 8 * lo.f4 + (threadIdx.x - lane);
  // the bf16 arm's rows (the heads' outputs go through its obs rows 0..9 as
  // floats, hx)
  uint16_t* actb =
      reinterpret_cast<uint16_t*>(sm + lo.hf + lo.wsm * 8 * lo.f4) +
      (threadIdx.x - lane);
  auto hx = [&](int col, int m) -> float& {
    float* row = reinterpret_cast<float*>(actb + (2 * col + (m >> 4)) * lo.as);
    return row[m & 15];
  };
  if constexpr (BF16) {
    for (int r = 0; r < lo.rows; ++r)  // K's padding of every layer
      actb[r * lo.as + lane] = 0;
  } else {
    for (int r = OBS_DIM; r < TOWER_OBS_ROWS; ++r)  // the obs' k padding
      act[r * lo.as + lane] = 0.0f;
  }
  load_params(pf, pi, P);  // ends with the barrier every copy needs
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < pl.n;
  if (!__any_sync(0xffffffffu, live)) return;  // no barrier follows

  const int n = pl.n, g = lane >> 2, t = lane & 3;
  const ALayer& hd = lo.ly[lo.L];
  Carry c{};
  if (live) c = read_carry(pl, i);
  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int s = 0; s < T; ++s) {
    float* out = traj + (size_t)s * N_TRAJ * n + i;
    float o[OBS_DIM];
    observe(c, o);
#pragma unroll
    for (int k = 0; k < OBS_DIM; ++k) {
      if constexpr (BF16)
        actb[k * lo.as + lane] = bf16_bits(live ? o[k] : 0.0f);
      else
        act[k * lo.as + lane] = live ? o[k] : 0.0f;
      if (live) out[(size_t)k * n] = o[k];
    }
    __syncwarp();
    float hacc[2][1][4];
    zero_frags(hacc);
    if constexpr (BF16) {
      const uint2* Wb = reinterpret_cast<const uint2*>(W);
      traj_tower_b16(lo, Wb, ba, actb, hacc);
      traj_tower_b16(lo, Wb + 2 * lo.f4, ba + lo.nb, actb, hacc);
    } else {
      traj_tower(lo, W, ba, act, hacc);
      traj_tower(lo, W + lo.f4, ba + lo.nb, act, hacc);
    }
    // the means and the value (head columns 0..4) over obs rows 0..4 (the
    // bf16 arm's: rows 0..9 as floats)
    if (t < 3)
#pragma unroll
      for (int ii = 0; ii < 2; ++ii)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int col = 2 * t + (r & 1), m = 16 * ii + g + (r & 2 ? 8 : 0);
          if (col < TRAJ_HEAD_OUT) {
            const float hv =
                hacc[ii][0][r] + ba[(col < 4 ? 0 : lo.nb) + hd.bo + col];
            if constexpr (BF16)
              hx(col, m) = hv;
            else
              act[col * lo.as + m] = hv;
          }
        }
    __syncwarp();
    float m[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      m[k] = BF16 ? hx(k, lane) : act[k * lo.as + lane];
    const float v = BF16 ? hx(TRAJ_VALUE_COL, lane)
                         : act[TRAJ_VALUE_COL * lo.as + lane];
    if (!live) continue;
    float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (STOCH) gauss4(c.k0, c.k1, c.rc, c.stp, z);
    // _sample_logp: the log-prob of the stored action
    float a[4], logp;
    sample_logp(m, z, sm, sm + 4, STOCH, a, logp);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[(size_t)(TP_ACT0 + k) * n] = a[k];
    out[(size_t)TP_LOGP * n] = logp;
    out[(size_t)TP_VAL * n] = v;
    float r, epret2;
    bool done;
    int step2;
    env_step<TASK, INTEG>(c, a[0], a[1], a[2], a[3], P, r, done, epret2,
                          step2);
    out[(size_t)TP_REW * n] = r;
    out[(size_t)TP_DONE * n] = done ? 1.0f : 0.0f;
    accumulate(acc, r, done, epret2, step2);
  }
  if (live) write_back(pl, i, c, acc);
}

template <int TASK, int INTEG, bool STOCH, bool BF16>
cudaError_t launch(const float* pf, const int* pi, const Planes& pl,
                   float* traj, const TLayout& lo, const float4* packed,
                   const float* theta, int ls_off, int T,
                   cudaStream_t stream) {
  const size_t smem = traj_smem(lo, BF16);
  cudaError_t err = cudaFuncSetAttribute(
      traj_kernel<TASK, INTEG, STOCH, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (pl.n + lo.bl - 1) / lo.bl;
  traj_kernel<TASK, INTEG, STOCH, BF16><<<blocks, lo.bl, smem, stream>>>(
      pf, pi, pl, traj, lo, packed, theta, ls_off, T);
  return cudaGetLastError();
}

template <int TASK, int INTEG, bool BF16>
cudaError_t launch_mode(const float* pf, const int* pi, const Planes& pl,
                        float* traj, const TLayout& lo, const float4* packed,
                        const float* theta, int ls_off, int T,
                        bool stochastic, cudaStream_t stream) {
  return stochastic
             ? launch<TASK, INTEG, true, BF16>(pf, pi, pl, traj, lo, packed,
                                               theta, ls_off, T, stream)
             : launch<TASK, INTEG, false, BF16>(pf, pi, pl, traj, lo, packed,
                                                theta, ls_off, T, stream);
}

}  // namespace drone

// C interface (ctypes). pf/pi: device env params; fs..stats: the state and
// statistic planes of rollout.cu; traj: device (T, 21, n) float32; theta:
// the device flat parameter buffer; packed: a device buffer of wfl floats
// the kernel packs the weights into. layout: host ints [n_hidden, lanes a
// block, fragments staged (0 or 1), dynamic shared memory bytes, wfl,
// width[MAX_HIDDEN], the actor's layer offsets into
// theta[MAX_HIDDEN + 1], the critic's[MAX_HIDDEN + 1], log_std's offset],
// the shared memory and wfl the kernel's own (ops/cuda_acting_traj.py
// traj_layout); bf16: 1 for the bf16 operand arm, 0 for 3xTF32.
extern "C" int drone_traj_rollout(const float* pf, const int* pi,
                                  const float* fs, const uint32_t* us,
                                  const int* st, float* ofs, uint32_t* ous,
                                  int* ost, float* stats, float* traj,
                                  const float* theta, float* packed,
                                  const int* layout, int stochastic, int bf16,
                                  int n, int T, int task, int integrator,
                                  void* stream) {
  using namespace drone;
  const int L = layout[0], bl = layout[1], wsm = layout[2];
  if (n <= 0 || T < 0 || L < 0 || L > MAX_HIDDEN || bl < 32 ||
      bl > TRAJ_MAX_LANES || bl % 32 != 0 || wsm < 0 || wsm > 1 ||
      bf16 < 0 || bf16 > 1)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l)
    if (layout[5 + l] <= 0 || layout[5 + l] > MAX_WIDTH)
      return (int)cudaErrorInvalidValue;
  TLayout lo;
  make_traj_layout(L, layout + 5, bl, wsm, bf16 != 0, lo);
  if ((size_t)layout[3] != traj_smem(lo, bf16 != 0) || layout[4] != lo.wfl ||
      traj_smem(lo, bf16 != 0) > (size_t)TRAJ_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  TSrc src;
  const int* offs = layout + 5 + MAX_HIDDEN;
  for (int tw = 0; tw < 2; ++tw)
    for (int l = 0; l <= MAX_HIDDEN; ++l)
      src.w[tw][l] = offs[tw * (MAX_HIDDEN + 1) + l];
  src.ls = offs[2 * (MAX_HIDDEN + 1)];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* pk = reinterpret_cast<float4*>(packed);
  const int threads = (bf16 ? 4 : 2) * lo.f4 + 2 * lo.nb;
  if (bf16)
    pack_traj_b16_kernel<<<(threads + 255) / 256, 256, 0, s>>>(
        theta, lo, src, reinterpret_cast<uint2*>(packed));
  else
    pack_traj_kernel<<<(threads + 255) / 256, 256, 0, s>>>(theta, lo, src,
                                                           pk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Planes pl{fs, us, st, ofs, ous, ost, stats, n};
  const bool sto = stochastic != 0;
#define DRONE_TRAJ_CASE(TK, IG)                                            \
  if (task == TK && integrator == IG)                                      \
    return bf16 ? (int)launch_mode<TK, IG, true>(pf, pi, pl, traj, lo, pk, \
                                                 theta, src.ls, T, sto, s) \
                : (int)launch_mode<TK, IG, false>(pf, pi, pl, traj, lo,    \
                                                  pk, theta, src.ls, T,    \
                                                  sto, s);
  DRONE_TRAJ_CASE(TASK_HOVER, INTEG_EULER)
  DRONE_TRAJ_CASE(TASK_HOVER, INTEG_RK4)
  DRONE_TRAJ_CASE(TASK_WAYPOINT, INTEG_EULER)
  DRONE_TRAJ_CASE(TASK_WAYPOINT, INTEG_RK4)
  DRONE_TRAJ_CASE(TASK_RACING, INTEG_EULER)
  DRONE_TRAJ_CASE(TASK_RACING, INTEG_RK4)
#undef DRONE_TRAJ_CASE
  return (int)cudaErrorInvalidValue;
}
