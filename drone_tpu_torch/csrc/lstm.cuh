// lstm.cuh — the LSTM policy's fp32 device functions over a tile of lanes,
// shared by the recurrent acting kernels (acting_lstm.cu: K8 and K6) and the
// truncated-BPTT update (update_lstm.cu: K7): the net's layout, the tanh
// dense encoder and the heads. The gate block runs on the tensor cores
// (lstm_mma.cuh) in every kernel.
//
// Ports drone_tpu/ops/pallas_acting_lstm.py `lstm_encoder` (tanh dense
// tower) and the heads of `_kernel`.
//
// One lane's LSTM does not fit a thread: at H = 128 a lane carries c and h
// (256 floats) and four gate sums (512). So a block owns a tile of lanes
// and shares the work on it: the tile's activations live in shared memory
// as rows of the tile (unit-major, [row][lane]); an encoder layer is register-tiled, a thread owning 4 output rows x 4 lanes
// and reading per input row one float4 of activations and its weights. The
// encoder is 4 (13 + ...) multiply-adds a unit against the gate block's
// 4 (E + H): it stays on the fp32 cores.
//
// Sums use explicit fmaf and run in another order than a matmul: the
// kernels are held to their plain versions at a tolerance. sigmoid is
// 1 / (1 + expf(-x)) and tanh is tanhf, as torch's CUDA kernels compute
// them.
//
// Two encoder arms, a template parameter of each kernel (ENC_DENSE,
// ENC_CNN), as the reference's encode_features switches between them: the
// tanh dense tower below, or the pixel-recurrent family's patch CNN
// (cnn_mma.cuh's tower forward, its trunk output the E = 128 input rows of
// the gate block). The CNN arm takes CNNLSTMActorCritic's default tower
// only, whose six tensors open the flat buffer at cnn.cuh's offsets
// (OFF_W0 .. OFF_BT): the cnn_lstm buffer's first 94,464 floats are laid
// out as PatchCNNActorCritic's.
//
// The bf16 arm (K7's compute_dtype="bfloat16"): the BF16 template
// parameter of the encoder and the heads rounds the activation operand of
// each multiply-add to bf16 (mma.cuh op_value) as it loads; the weight
// operand comes rounded already, the caller passing a copy of the flat
// buffer whose weights it rounded once (update_lstm.cu
// round_weights_kernel; its biases as they are). Each product of two bf16
// values is exact in fp32 and sums in fp32, as the reference's _dot32.
#pragma once

#include <cuda_runtime.h>

#include "cnn.cuh"
#include "mma.cuh"
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

// An empty callback of lstm_encoder, for kernels that keep no layer.
struct NoLayerOut {
  __device__ void operator()(int, const float*, int) const {}
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
// nout rows from nin input rows (LANES lanes; input rows SI floats apart,
// output rows SO). Every thread of the block takes part; no barrier at the
// end. BF16: the inputs rounded as they load (W rounded by the caller).
template <int LANES, int SI, int SO, bool BF16 = false>
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
      float4 x = *reinterpret_cast<const float4*>(in + k * SI + l0);
      if constexpr (BF16) {
        x.x = op_value<true>(x.x);
        x.y = op_value<true>(x.y);
        x.z = op_value<true>(x.z);
        x.w = op_value<true>(x.w);
      }
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
      *reinterpret_cast<float4*>(out + (j0 + i) * SO + l0) = y;
    }
  }
}

// The encoder tower (lstm_encoder): obs rows -> x, the gate block's input
// rows. Hidden layers before the last alternate between buf0 and buf1; the
// obs and those buffers have rows SB floats apart, x rows SX apart. After
// each layer (and its barrier) on_layer(i, out, stride) sees its output
// rows. With no encoder layer the caller writes the obs straight into x.
// BF16: dense_tanh's bf16 arm (theta's weights rounded by the caller).
template <int LANES, int SB, int SX, bool BF16 = false, class OnLayer>
__device__ __forceinline__ void lstm_encoder(const float* obs, float* buf0,
                                             float* buf1, float* x,
                                             const float* __restrict__ theta,
                                             const LstmNet& net,
                                             const OnLayer& on_layer) {
  const float* in = obs;
  int nin = OBS_DIM;
  for (int i = 0; i < net.n_enc; ++i) {
    const float* W = theta + net.enc_off[i];
    if (i == net.n_enc - 1) {
      dense_tanh<LANES, SB, SX, BF16>(W, net.enc_w[i], nin, in, x);
      __syncthreads();
      on_layer(i, x, SX);
    } else {
      float* out = i & 1 ? buf1 : buf0;
      dense_tanh<LANES, SB, SB, BF16>(W, net.enc_w[i], nin, in, out);
      __syncthreads();
      on_layer(i, out, SB);
      in = out;
      nin = net.enc_w[i];
    }
  }
}

// The action head (4 means) and the value head at h' of lane threadIdx.x
// / 4 (rows `stride` floats apart): dot(W, h') + b, as the reference. The
// block's threads 4 l .. 4 l + 3 share lane l, thread q summing units q, q
// + 4, ...; a butterfly adds the four partial sums, so each of the four
// ends with the same m and v. Each thread reads only the units it sums.
// BF16: h' rounded as it loads (the heads' W rounded by the caller).
template <bool BF16 = false>
__device__ __forceinline__ void lstm_heads4(const float* h, int stride,
                                            const float* __restrict__ theta,
                                            const LstmNet& net, float m[4],
                                            float& v) {
  const int H = net.H, l = threadIdx.x >> 2;
  const float* hw = theta + net.head_off;
  const float* vw = theta + net.vhead_off;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int u = threadIdx.x & 3; u < H; u += 4) {
    const float hv = op_value<BF16>(h[u * stride + l]);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] = __fmaf_rn(__ldg(hw + k * H + u), hv, acc[k]);
    acc[4] = __fmaf_rn(__ldg(vw + u), hv, acc[4]);
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    acc[k] = acc[k] + __shfl_xor_sync(0xffffffffu, acc[k], 1);
    acc[k] = acc[k] + __shfl_xor_sync(0xffffffffu, acc[k], 2);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) m[k] = acc[k] + __ldg(hw + 4 * H + k);
  v = acc[4] + __ldg(vw + H);
}

}  // namespace drone
