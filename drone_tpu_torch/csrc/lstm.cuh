// lstm.cuh — the LSTM policy as CUDA device functions over a tile of lanes,
// shared by the recurrent acting kernels (acting_lstm.cu: K8 and K6) and the
// truncated-BPTT update (update_lstm.cu: K7).
//
// Ports drone_tpu/ops/pallas_acting_lstm.py `lstm_encoder` (tanh dense
// tower) and `lstm_gates` (flax OptimizedLSTMCell):
//   i = sig(x Wi_i + h Wh_i + b_i)   f = sig(...)   g = tanh(...)   o = sig(...)
//   c' = f*c + i*g ;  h' = o*tanh(c')
//
// Unlike the MLP tower, one lane's LSTM does not fit a thread: at H = 128 a
// lane carries c and h (256 floats) and four gate sums (512). So a block
// owns a tile of LANES lanes and shares the work on it:
//   - the tile's activations live in shared memory as rows of LANES floats
//     (unit-major, [row][lane]): the encoder's layers, then x and h stacked
//     as one (E + H)-row block `xh`, and the cell state c;
//   - each product is register-tiled: a thread owns 4 output rows x 4 lanes
//     (the gate block: 4 units x 4 gates x 4 lanes, 64 sums) and per input
//     row reads one float4 of activations and its weights;
//   - the gate weights are packed on the host as WP (E + H, H, 4): per input
//     row k and unit u the 4 gates' weights as one float4, so a thread's 4
//     units are 4 float4 loads. With LANES = 128 a warp's threads share
//     their units and every weight load is a broadcast. The 393 KB of gate
//     weights at H 128 / E 64 do not fit shared memory; they stream from L2
//     each step, read once per tile (64 operations per byte at 128 lanes).
//
// Sums use explicit fmaf and run in another order than a matmul: the
// kernels are held to their plain versions at a tolerance. sigmoid is
// 1 / (1 + expf(-x)) and tanh is tanhf, as torch's CUDA kernels compute
// them.
//
// Two encoder arms, a template parameter of each kernel (ENC_DENSE,
// ENC_CNN), as the reference's encode_features switches between them: the
// tanh dense tower below, or the pixel-recurrent family's patch CNN
// (cnn.cuh's window-by-window forward, its trunk output written into the
// first E = 128 rows of xh). The CNN arm takes CNNLSTMActorCritic's
// default tower only, whose six tensors open the flat buffer at cnn.cuh's
// offsets (OFF_W0 .. OFF_BT): the cnn_lstm buffer's first 94,464 floats are
// laid out as PatchCNNActorCritic's.
#pragma once

#include <cuda_runtime.h>

#include "cnn.cuh"
#include "policy.cuh"

namespace drone {

enum { ENC_DENSE = 0, ENC_CNN = 1 };

constexpr int MAX_ENC = 4;
constexpr int LSTM_MAX_H = 128;
constexpr int LSTM_THREADS = 256;
// host layout ints: [n_enc, H, enc_w[MAX_ENC], enc_off[MAX_ENC], head_off,
// vhead_off, ls_off]
constexpr int NET_INTS = 5 + 2 * MAX_ENC;

// Where the policy's tensors sit in the flat parameter buffer (the
// reference's lstm_kernel_tensors order): encoder layer i's W (out, in) at
// enc_off[i] with its bias after it; the action head W (4, H) then b (4) at
// head_off; the value head W (1, H) then b (1) at vhead_off; log_std at
// ls_off. The gate weights go to the kernels packed (WP, BP).
struct LstmNet {
  int n_enc, H, E, enc_rows;  // E: the LSTM's input width; enc_rows: sum of
                              // the encoder widths
  int enc_w[MAX_ENC];
  int enc_off[MAX_ENC];
  int head_off, vhead_off, ls_off;
};

// The layout of an ENC_CNN net has no dense layer (n_enc 0); E is the
// trunk's width.
inline bool read_net(const int* layout, int encoder, LstmNet& net) {
  net.n_enc = layout[0];
  net.H = layout[1];
  if (net.n_enc < 0 || net.n_enc > MAX_ENC || net.H <= 0 ||
      net.H > LSTM_MAX_H || net.H % 4 != 0 ||
      (encoder != ENC_DENSE && encoder != ENC_CNN) ||
      (encoder == ENC_CNN && net.n_enc != 0))
    return false;
  net.E = OBS_DIM;
  net.enc_rows = 0;
  for (int i = 0; i < MAX_ENC; ++i) {
    net.enc_w[i] = layout[2 + i];
    net.enc_off[i] = layout[2 + MAX_ENC + i];
  }
  for (int i = 0; i < net.n_enc; ++i) {
    if (net.enc_w[i] <= 0) return false;
    net.E = net.enc_w[i];
    net.enc_rows += net.enc_w[i];
  }
  if (encoder == ENC_CNN) net.E = CNN_H;
  net.head_off = layout[2 + 2 * MAX_ENC];
  net.vhead_off = layout[3 + 2 * MAX_ENC];
  net.ls_off = layout[4 + 2 * MAX_ENC];
  return true;
}

// Empty callbacks of lstm_encoder and lstm_gates, for kernels that keep
// nothing of a step.
struct NoLayerOut {
  __device__ void operator()(int, const float*) const {}
};
struct NoGateOut {
  __device__ void operator()(int, int, const float*, const float*,
                             const float*, const float*, const float*,
                             const float*, const float*) const {}
};

// The widest encoder layer before the last and the number of ping-pong
// buffers lstm_encoder needs for them.
__host__ __device__ inline void enc_buffers(const LstmNet& net, int& maxw,
                                            int& nbuf) {
  maxw = 0;
  for (int i = 0; i + 1 < net.n_enc; ++i)
    maxw = net.enc_w[i] > maxw ? net.enc_w[i] : maxw;
  nbuf = net.n_enc >= 3 ? 2 : (net.n_enc == 2 ? 1 : 0);
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// One encoder layer over the tile: out[j] = tanh(W[j] . in + b[j]) for
// nout rows from nin input rows. Every thread of the block takes part; no
// barrier at the end.
template <int LANES>
__device__ __forceinline__ void dense_tanh(const float* __restrict__ W,
                                           int nout, int nin, const float* in,
                                           float* out) {
  constexpr int LB = LANES / 4;
  const float* b = W + nout * nin;
  const int tiles = ((nout + 3) / 4) * LB;
  for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
    const int j0 = 4 * (tile / LB), l0 = 4 * (tile % LB);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    for (int k = 0; k < nin; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(in + k * LANES + l0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = j0 + i < nout ? __ldg(W + (j0 + i) * nin + k) : 0.0f;
        acc[i][0] = __fmaf_rn(w, x.x, acc[i][0]);
        acc[i][1] = __fmaf_rn(w, x.y, acc[i][1]);
        acc[i][2] = __fmaf_rn(w, x.z, acc[i][2]);
        acc[i][3] = __fmaf_rn(w, x.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (j0 + i >= nout) break;
      const float bias = __ldg(b + j0 + i);
      float4 y;
      y.x = tanhf(acc[i][0] + bias);
      y.y = tanhf(acc[i][1] + bias);
      y.z = tanhf(acc[i][2] + bias);
      y.w = tanhf(acc[i][3] + bias);
      *reinterpret_cast<float4*>(out + (j0 + i) * LANES + l0) = y;
    }
  }
}

// The encoder tower (lstm_encoder): obs rows -> x, the first E rows of xh.
// Hidden layers before the last alternate between buf0 and buf1. After each
// layer (and its barrier) on_layer(i, out) sees its output rows. With no
// encoder layer the caller writes the obs straight into xh.
template <int LANES, class OnLayer>
__device__ __forceinline__ void lstm_encoder(const float* obs, float* buf0,
                                             float* buf1, float* xh,
                                             const float* __restrict__ theta,
                                             const LstmNet& net,
                                             const OnLayer& on_layer) {
  const float* in = obs;
  int nin = OBS_DIM;
  for (int i = 0; i < net.n_enc; ++i) {
    float* out = i == net.n_enc - 1 ? xh : (i & 1 ? buf1 : buf0);
    dense_tanh<LANES>(theta + net.enc_off[i], net.enc_w[i], nin, in, out);
    __syncthreads();
    on_layer(i, out);
    in = out;
    nin = net.enc_w[i];
  }
}

// The gate block of one step (lstm_gates) for the tile: reads x and h from
// xh and c, writes c' over c and, after a barrier, h' over the h rows of
// xh. A thread owns 4 units x 4 lanes per pass and keeps each pass's h' in
// registers until every thread has read h (MAXP passes cover H/4 x LANES/4
// tiles with the block's threads). KU unrolls the loop over input rows, to
// keep more weight loads from L2 in flight: each kernel takes as many as
// its registers allow. epi(u, l0, gi, gf, gg, go, c_in, th, h') sees each
// unit's 4 lanes (arrays of 4) before the barrier. The caller needs a
// barrier before it reads h'.
template <int LANES, int MAXP, int KU, class Epi>
__device__ __forceinline__ void lstm_gates(float* xh, float* c, int E, int H,
                                           const float4* __restrict__ WP,
                                           const float4* __restrict__ BP,
                                           const Epi& epi) {
  constexpr int LB = LANES / 4;
  const int UB = H / 4;
  const int K = E + H;
  float hn[MAXP][4][4];
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    const int tile = threadIdx.x + p * blockDim.x;
    const int ub = tile / LB, l0 = 4 * (tile % LB);
    if (ub >= UB) continue;
    const int u0 = 4 * ub;
    float acc[4][4][4];  // [unit][gate][lane]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][g][q] = 0.0f;
    const float4* w = WP + u0;
#pragma unroll (KU)
    for (int k = 0; k < K; ++k) {
      const float4 x4 = *reinterpret_cast<const float4*>(xh + k * LANES + l0);
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 w4 = __ldg(w + (size_t)k * H + j);
        const float wg[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[j][g][q] = __fmaf_rn(wg[g], x[q], acc[j][g][q]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int u = u0 + j;
      const float4 b = __ldg(BP + u);
      float gi[4], gf[4], gg[4], go[4], cin[4], th[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        gi[q] = sigmoidf(acc[j][0][q] + b.x);
        gf[q] = sigmoidf(acc[j][1][q] + b.y);
        gg[q] = tanhf(acc[j][2][q] + b.z);
        go[q] = sigmoidf(acc[j][3][q] + b.w);
        float* cp = c + u * LANES + l0 + q;
        cin[q] = *cp;
        const float c2 = gf[q] * cin[q] + gi[q] * gg[q];
        *cp = c2;
        th[q] = tanhf(c2);
        hn[p][j][q] = go[q] * th[q];
      }
      epi(u, l0, gi, gf, gg, go, cin, th, hn[p][j]);
    }
  }
  __syncthreads();  // every thread has read h
#pragma unroll
  for (int p = 0; p < MAXP; ++p) {
    const int tile = threadIdx.x + p * blockDim.x;
    const int ub = tile / LB, l0 = 4 * (tile % LB);
    if (ub >= UB) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(xh + (E + 4 * ub + j) * LANES + l0) =
          make_float4(hn[p][j][0], hn[p][j][1], hn[p][j][2], hn[p][j][3]);
  }
}

// The action head (4 means) and the value head at lane l's h' (rows
// `stride` floats apart): dot(W, h') + b, as the reference.
__device__ __forceinline__ void lstm_heads(const float* h, int stride, int l,
                                           const float* __restrict__ theta,
                                           const LstmNet& net, float m[4],
                                           float& v) {
  const int H = net.H;
  const float* hw = theta + net.head_off;
  const float* vw = theta + net.vhead_off;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int u = 0; u < H; ++u) {
    const float hv = h[(size_t)u * stride + l];
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = __fmaf_rn(__ldg(hw + k * H + u), hv, acc[k]);
    acc[4] = __fmaf_rn(__ldg(vw + u), hv, acc[4]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = acc[k] + __ldg(hw + 4 * H + k);
  v = acc[4] + __ldg(vw + H);
}

}  // namespace drone
