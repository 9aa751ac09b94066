// update_lstm.cu — the truncated-BPTT PPO update (K7): one minibatch of the
// LSTM policy's forward and hand-written backward through time, its
// gradients and the 8 stat sums.
//
// Replaces drone_tpu/ops/pallas_update_lstm.py `_lstm_update_kernel`
// (driven by `ppo_lstm_update`). Wrapper and plain version:
// ops/cuda_update_lstm.py.
//
// Per call pack_gates_kernel and pack_gates_t_kernel split the gate
// weights once into their (big, small) tensor-core fragments, the
// forward's and the backward's (lstm_mma.cuh; the bf16 arm's packers below
// write bf16x2 words). Then, for each bptt segment
// of the minibatch in turn:
//   bptt_kernel (the walk): a block of 256 threads owns 64 lanes of the
//     minibatch. It runs the segment forward from its (c, h) anchor (the
//     dense encoder on the fp32 cores, the gate block on the tensor cores
//     in 3xTF32, lstm_mma.cuh lstm_gates_mma), storing each step's
//     activations in a device scratch (and the heads' outputs, which four
//     threads a lane compute from h' in shared memory), then walks the
//     steps backward: the PPO head's gradients per lane (policy.cuh
//     head_grads, K3's), dh' and dc' through the cell, the gate
//     pre-activation gradients dz (4H per sample, copied row by row to the
//     GZ scratch), dx and the next dh from one tensor-core product with the
//     transposed fragments (gates_bwd_mma), and the encoder's dpre (fp32).
//     A thread owns the same (lane, unit)
//     pairs in the gate block, the cell's backward and dh's product, so c,
//     dh and dc live in its registers, not in shared memory. The gradient
//     entering step t through time is masked by step t's keep; it stops at
//     the anchor (truncation). Each block sums its lanes' 8 stats in a
//     fixed order into its own row.
//   grad_mma_kernel (the products): the weight gradients as products over
//     the segment's samples on the tensor cores in 3xTF32, dW = sum_s A[:,
//     s] B[:, s]^T with the bias sums beside them (dz x [x; h_in] for the
//     gates, [dm; g_v] x h' for the heads, dpre x the layer input for the
//     encoder, the CNN arm's dzt x X2). A block takes a 64 x 64 tile over a
//     fixed chunk of one step's lanes and writes its own partial row; its
//     sums start each window of 64 samples from zero in the tensor cores'
//     accumulators and add it to the chunk's total with IEEE adds (fold).
//   lstm_reduce_kernel: adds the partial rows of every segment and chunk in
//     a fixed order into the flat gradient, and the stat rows into the 8
//     sums (log_std's gradient is its stat sums minus ent_coef).
// No float atomics: two launches on the same inputs give the same bits, so
// training on the card is deterministic and a resume repeats a run.
//
// The reference re-runs the forward from chunk-boundary carries because a
// segment's activations overflow VMEM; here they fit in device memory
// (~1.2 GB per segment at 16,384 lanes x 16 steps, H 128, E 64), so one
// forward per step is run, not 1 + 1.375.
//
// Shared memory of the walk, rows of the tile: forward, the obs and the
// dense encoder's buffers at stride 64 (fp32 rows) and x and h at the
// tensor-core tiles' TM_S = 72 (their A fragments' 32 reads hit 32 banks);
// backward, dz, dx, [dm; g_v] and keep at 72. At stride 72 the old
// backward rows (dh, dc, dz, dx: 6H + maxe + 6) would not fit beside the
// CNN arm's E = 128 (259,776 bytes, over a block's 232,448); with c, dh and
// dc in registers they are 4H + maxe + 6: 167,616 bytes at H 128 / E 64,
// 186,048 in the CNN arm (one block an SM). Every shape the fp32 walk took
// fits.
//
// What bounds it on an H100: per sample 3 x 4H (E + H) multiply-adds at
// the 3xTF32 rate (forward, [dx; dh], the gates' weight product: 294,912 at
// H 128 / E 64), the rest (encoder, heads, cell) on the fp32 cores, and
// the scratch's bytes: the forward writes ~1,100 floats a sample (the gate
// block's six quantities over its padded units among them), the walk back
// reads ~840 and writes ~580, the products read ~910 (each operand once;
// 13.75 KB a sample in all, 28.8 GB a minibatch at the reference's
// geometry); the gate fragments come from L2, 786,432 bytes a tile-step
// each way. What takes the time on the card is the tensor cores' mma.sync
// and the operands' split (two cvt.rna a value, in every warp that reads
// an A fragment): PERF.md.
//
// The CNN arm (pixel-recurrent cnn_lstm, the reference's encoder == "cnn"
// branch). The tower depends on no recurrent state, so it leaves the walk
// through time: per segment, pack_tower_kernel having split the tower's
// weights once into their (big, small) fragments,
//   tower_fwd_kernel: the tower's forward over the segment's bptt x NL
//     samples, 64-sample tiles on the tensor cores in 3xTF32 (cnn_mma.cuh
//     tower_fwd_tile, two blocks an SM), writing the obs and x (the XS
//     rows 0 .. OBS_DIM + 128) and each window's conv1 output (the trunk's
//     input X2, 576 rows a sample, the X2S scratch);
//   bptt_kernel<ENC_CNN>: reads x from XS as the dense arm reads its
//     encoder's output, walks the LSTM, and ends at dzt = dx * (x > 0), the
//     gradient at the trunk's pre-activation, to the scratch;
//   tower_bwd_kernel (cnn_mma.cuh, K10's): the tower's backward on the
//     tensor cores (the patches re-rendered from the stored obs, conv0
//     re-run, gW0 and gW1 in a block's registers over fixed 64-sample
//     tiles), its block rows written into the product rows' first OFF_WT
//     columns;
//   the products, gWt and gbt among them (dzt x X2).
// Per sample the arm adds ~1.1 M multiply-adds to the LSTM's 3 x 131k: the
// forward tower 369k, conv0 again 147k, dX2 74k, gW1 147k, dX1 147k, gW0
// 147k, gWt 74k, all on the tensor cores; one segment's scratch is ~1.9 GB
// at 16,384 lanes x 16 steps, H 128.
//
// The bf16 arm (compute_dtype="bfloat16", both encoders: the reference's
// _segment_grads with _dot32 rounding both operands of every product): the
// BF16 template parameter of the walk, the tower's kernels and the
// products. Per call round_weights_kernel writes a copy of the flat buffer
// whose weights the walk reads on the fp32 cores (the dense encoder's and
// the heads') are rounded to bf16, its biases and log_std as they are; the
// walk reads that copy. The CNN arm's weight products (grad_mma_kernel
// <true>: mma.cuh grad_b16_tile) and tower kernels (cnn_mma.cuh
// tower_fwd_b16, tower_bwd_b16, the weights packed by pack_tower_kernel
// <true>) run on the bf16 tensor cores, m16n8k16 products of operands
// stored once as bf16 rows, and so does the walk's gate block and [dx; dh]
// in both arms (bptt_walk_b16: lstm_mma.cuh lstm_gates_b16, gates_bwd_b16;
// x, h and dz as bf16 rows of the tile, the gate weights as bf16x2
// fragments, pack_gates_b16_kernel and pack_gates_t_b16_kernel, which reach
// each warp through a ring in shared memory that cp.async fills three
// k-tiles ahead: L2's latency, not its bytes, set the first bf16 design's
// products). The dense arm's weight products (grad_rounded_kernel) keep
// one TF32 product a k-step of bf16 values, bit for bit the first bf16
// design's, from each window's operands rounded once into bf16x2 rows
// (their m16n8k16 form moved the one-run bf16 LSTM gate, ROADMAP H11). On
// the fp32 cores the encoder and the heads round their activations as
// they load (lstm.cuh), and the walk stores [dm; g_v] and the
// dense layers' dpre rounded in shared memory for dh' and the layer input
// gradient. The bias sums, the cell's elementwise math, the head's
// subgradients, the stored activations (the scratch) and the folds of the
// products' windows stay fp32; the walk's GF keeps five of the six
// quantities and recomputes tanh(c') from them, bit for bit. Shared
// memory: the bf16 walk's 126,656 bytes at H 128 / E 64, 145,088 in the
// CNN arm (one block an SM); the dense arm's products' GR_SMEM; the CNN
// arm's products' and tower kernels' the bf16 designs' (GB_SMEM, TFB_SMEM,
// TBB_SMEM).

#include <cuda_runtime.h>

#include <cstdint>

// the bf16 tower backward takes one block an SM here: K7 launches one a
// product row (cnn_mma.cuh TBB_PER_SM)
#define DRONE_TBB_PER_SM 1
#include "cnn_mma.cuh"
#include "lstm.cuh"
#include "lstm_mma.cuh"

namespace drone {

constexpr int N_UPSTATS = 8;
constexpr int BP_LANES = TM_L;  // lanes of a walk's tile
// the gate-gradient products: 64 x 64 output tiles over windows of 64
// samples; their operand tiles' rows GM_S floats apart (4 mod 32: a
// sample-major fragment's 32 reads hit 32 banks), A and B double-buffered
constexpr int GM_T = 64;
constexpr int GM_S = 68;
constexpr int GM_SMEM = 2 * 2 * GM_T * GM_S * 4;  // 69,632
// scratch buffers, each (bptt, rows, NL): X2S only in the CNN arm, DP the
// dense encoder's dpre or the CNN arm's dzt. GF holds the gate block's
// gi, gf, gg, go, c_in and tanh(c') (6 Hp rows a step; the bf16 walk's the
// first five, GF_B16 Hp rows, tanh(c') recomputed from them bit for bit) in
// its threads' order: a tile's GF_Q Hp x 64 floats as [unit group][m-tile]
// [quantity][fragment][lane of the warp], so the forward writes and the
// walk back reads 128 contiguous bytes a warp instruction (gf_at).
enum { XS = 0, GZ = 1, GF = 2, H2S = 3, DMV = 4, DP = 5, N_SCRATCH = 6,
       X2S = 6, N_BUFS = 7 };
// the tower's forward takes two blocks an SM; its block count is a
// constant (its tiles write no sums)
constexpr int TOWER_FWD_BLOCKS = 264;

struct BpttArgs {
  const float* planes;  // (T, 21, n)
  const float* advret;  // (2, T, n)
  const float* snap;    // (S, 2, H, n)
  const int* perm;      // (n_sel,) row blocks of the minibatch
  const float* theta;
  const float4* PG;     // the gate weights' forward fragments
  const float4* PGT;    // ... and the transposed ones
  const float4* BP;     // (H, 4)
  float* s[N_SCRATCH];  // each (bptt, rows, NL)
  float* stat_part;     // (blocks, 8) of this segment
  int n, T, bptt, seg, rbl, NL;
};

// out[r] = sum_j W[j][r] d[j] over a tile (W (nout, nin) row-major, r <
// nin, rows of LANES lanes S floats apart): the input gradient of a dense
// layer.
template <int LANES, int S>
__device__ __forceinline__ void dense_t(const float* __restrict__ W, int nout,
                                        int nin, const float* d, float* out) {
  constexpr int LB = LANES / 4;
  const int tiles = ((nin + 3) / 4) * LB;
  for (int tile = threadIdx.x; tile < tiles; tile += blockDim.x) {
    const int r0 = 4 * (tile / LB), l0 = 4 * (tile % LB);
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
    for (int j = 0; j < nout; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(d + j * S + l0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = r0 + i < nin ? __ldg(W + j * nin + r0 + i) : 0.0f;
        acc[i][0] = __fmaf_rn(w, x.x, acc[i][0]);
        acc[i][1] = __fmaf_rn(w, x.y, acc[i][1]);
        acc[i][2] = __fmaf_rn(w, x.z, acc[i][2]);
        acc[i][3] = __fmaf_rn(w, x.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i >= nin) break;
      *reinterpret_cast<float4*>(out + (r0 + i) * S + l0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// The offset in a tile's GF chunk (NQ quantities) of quantity q of the
// pair this thread owns as fragment r of m-tile i in pass p.
constexpr int GF_B16 = 5;
template <int NQ = 6>
__device__ __forceinline__ int gf_at(int p, int i, int q, int r) {
  const int ug = (threadIdx.x >> 5) + GATE_WARPS * p;
  return (((ug * 4 + i) * NQ + q) * 4 + r) * 32 + (threadIdx.x & 31);
}

// The bf16 walk's forward product runs K = Ep + Hp rows in k-tiles of 16,
// zero rows after h's up to a multiple of 16.
__host__ __device__ constexpr int gate_k16(int E, int H) {
  return (gate_inputs(E) + gate_units(H) + 15) / 16 * 16;
}
// ... and its gate fragments' words: gate_k16 rows x 4 Hp columns, two
// bf16 a word.
__host__ __device__ constexpr int gate_b16_words(int E, int H) {
  return gate_k16(E, H) * gate_units(H) * 2;
}

// The widest dense encoder layer (the CNN arm: its E).
__host__ __device__ inline int widest_layer(const LstmNet& net, int encoder) {
  if (encoder == ENC_CNN) return net.E;
  int maxe = 0;
  for (int i = 0; i < net.n_enc; ++i)
    maxe = net.enc_w[i] > maxe ? net.enc_w[i] : maxe;
  return maxe;
}

// The rows of dx in the walk's backward: the product's Ep, and the dense
// encoder's input gradients.
__host__ __device__ inline int dx_rows(const LstmNet& net, int encoder) {
  const int Ep = gate_inputs(net.E), maxe = widest_layer(net, encoder);
  return maxe > Ep ? maxe : Ep;
}

// the bf16 walk's warps' fragment rings (lstm_mma.cuh)
constexpr int WALK_RING_FLOATS = GATE_WARPS * B16_RING_BYTES / 4;

// The walk's shared floats: the larger of the forward's (the obs and the
// encoder's buffers at stride 64, x and h at TM_S) and the backward's (dz,
// dx, [dm; g_v] and keep at TM_S). bf16 (bptt_walk_b16): x and h as bf16
// rows (TMB; zero rows up to a multiple of 16), the dense arm's last layer
// in fp32 rows of 64 beside the obs and buffers; dz as bf16 rows, a region
// that the dense encoder's
// backward reuses for fp32 rows of its layers before the last; the CNN
// arm's next x in fp32 rows; the warps' fragment rings (after x and h over
// the dense encoder's rows, which the gate block no longer reads; after
// dz's rows, under the rows the dense encoder's backward reuses).
__host__ __device__ inline int bptt_smem_floats(const LstmNet& net,
                                                int encoder, bool bf16) {
  int maxw, nbuf;
  enc_buffers(net, maxw, nbuf);
  const int Ep = gate_inputs(net.E), Hp = gate_units(net.H);
  const int rows = dx_rows(net, encoder) + 6;  // dx, [dm; g_v], keep
  if (bf16) {
    const int R = WALK_RING_FLOATS;
    int fwd = gate_k16(net.E, net.H) * TMB / 2;
    if (encoder == ENC_CNN) {
      fwd += BP_LANES * CNN_H + R;
    } else {
      const int enc = BP_LANES * (OBS_DIM + nbuf * maxw + (net.n_enc ? net.E : 0));
      fwd += enc > R ? enc : R;
    }
    const int dz = 4 * Hp * TMB / 2 + R, d2 = maxw * TM_S;
    const int bwd = (dz > d2 ? dz : d2) + TM_S * rows;
    return fwd > bwd ? fwd : bwd;
  }
  int fwd = TM_S * (Ep + Hp);
  if (encoder != ENC_CNN) fwd += BP_LANES * (OBS_DIM + nbuf * maxw);
  const int bwd = TM_S * (4 * Hp + rows);
  return fwd > bwd ? fwd : bwd;
}

// The transposed fragments (gate_t_frags float4s) for dz [Wi; Wh]^T (the
// walk's backward product; lstm_mma.cuh gates_bwd_mma): B[k][n]
// with k = 32 ug + 8 gate + j (the forward's column order: unit 8 ug + j)
// and n the gate block's input row (x's Ep, then h's Hp).
__global__ void pack_gates_t_kernel(const float* __restrict__ wp, int E,
                                    int H, float4* __restrict__ pgt) {
  const int NT = gate_t_ntiles(E, H);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= gate_t_frags(E, H)) return;
  const int lane = i % 32, tile = i / 32, kt = tile / NT, nt = tile % NT;
  const int n = 8 * nt + lane / 4, k = 8 * kt + lane % 4;
  const int row = gate_row(n, E, H);
  float v[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kk = k + 4 * r;
    const int u = 8 * (kk / 32) + kk % 8, gate = (kk / 8) % 4;
    v[r] = u < H && row >= 0 ? wp[((size_t)row * H + u) * 4 + gate] : 0.0f;
  }
  pgt[i] = pack_pair(v);
}

// The gate weights' bf16x2 fragments of m16n8k16 (gate_b16_words uint32s,
// two uint4s a lane of each k-tile of 16 and unit group, [k-tile][ug][lane]):
// word c of the lane's eight is pair c % 2 of n-tile 4 ug + c / 2 (gate c /
// 2 of the unit group), {bf16(B[k][n]), bf16(B[k + 1][n])} at k = 16 kt + 2
// t + 8 (c % 2), n = 8 (4 ug + c / 2) + g (mma.cuh mma_bf16's b0, b1), with B
// as pack_gates_kernel's; rows past Ep + Hp zero.
__global__ void pack_gates_b16_kernel(const float* __restrict__ wp, int E,
                                      int H, uint32_t* __restrict__ pg) {
  const int UG = gate_units(H) / 8;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= gate_b16_words(E, H)) return;
  const int c = i % 8, lane = (i / 8) % 32, ug = (i / 256) % UG;
  const int kt = i / (256 * UG), q = c / 2;
  const int k = 16 * kt + 2 * (lane % 4) + 8 * (c % 2), u = 8 * ug + lane / 4;
  float v[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gate_row(k + r, E, H);
    v[r] = u < H && row >= 0 ? wp[((size_t)row * H + u) * 4 + q] : 0.0f;
  }
  pg[i] = bf16x2(v[0], v[1]);
}

// The transposed fragments of m16n8k16 (gate_t_frags uint32s, a uint2 a
// lane of each k-tile of 16 and n-tile, [k-tile][n-tile][lane]): word c of
// the pair {bf16(B[k][n]), bf16(B[k + 1][n])} at k = 16 kt + 2 t + 8 c, n = 8
// nt + g, with B, k and n as pack_gates_t_kernel's.
__global__ void pack_gates_t_b16_kernel(const float* __restrict__ wp, int E,
                                        int H, uint32_t* __restrict__ pgt) {
  const int NT = gate_t_ntiles(E, H);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= gate_t_frags(E, H)) return;
  const int c = i % 2, lane = (i / 2) % 32, tile = i / 64;
  const int kt = tile / NT, nt = tile % NT;
  const int n = 8 * nt + lane / 4, k = 16 * kt + 2 * (lane % 4) + 8 * c;
  const int row = gate_row(n, E, H);
  float v[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kk = k + r;
    const int u = 8 * (kk / 32) + kk % 8, gate = (kk / 8) % 4;
    v[r] = u < H && row >= 0 ? wp[((size_t)row * H + u) * 4 + gate] : 0.0f;
  }
  pgt[i] = bf16x2(v[0], v[1]);
}

// The heads (lstm_heads4<true>) at h' in bf16 rows: the same sums of the
// same rounded values.
__device__ __forceinline__ void heads4_b16(const uint16_t* h,
                                           const float* __restrict__ theta,
                                           const LstmNet& net, float m[4],
                                           float& v) {
  const int H = net.H, c = threadIdx.x >> 2;
  const float* hw = theta + net.head_off;
  const float* vw = theta + net.vhead_off;
  float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int u = threadIdx.x & 3; u < H; u += 4) {
    const float hv = b16_value(h[u * TMB + c]);
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

// The bf16 arm's walk (bptt_kernel<ENC, true>): the fp32 walk's steps and
// ownership, its products from operands stored once as bf16 (lstm_mma.cuh
// lstm_gates_b16, gates_bwd_b16). Forward: x and h as bf16 rows; the dense
// arm's obs, encoder buffers and last layer in fp32 rows of L floats (the
// last layer goes to XS in fp32 and to x in bf16). Backward: dz as bf16
// rows, its fp32 values straight from the cell's registers to the GZ
// scratch; dx, [dm; g_v] and keep as the fp32 walk's. Every fp32 reader
// keeps its value: XS's encoder outputs ((1 - y^2)), GZ (the bias sums),
// the CNN arm's x (its relu mask, read from XS). h is read only rounded
// (the products, the heads, XS's h_in, which the products round, and the
// carry mask by 0 or 1 give the same bits from bf16(h)): it is kept as
// bf16 alone.
template <int ENC>
__device__ __forceinline__ void bptt_walk_b16(const BpttArgs& A,
                                              const LstmNet& net,
                                              const UConsts& co) {
  constexpr bool CNN = ENC == ENC_CNN;
  constexpr int L = BP_LANES, S = TM_S;
  extern __shared__ float4 smem4[];
  const int H = net.H, E = net.E, n = A.n, NL = A.NL, tid = threadIdx.x;
  const int Hp = gate_units(H), Ep = gate_inputs(E), UG = Hp / 8;
  const int w = tid >> 5;
  float* sm = reinterpret_cast<float*>(smem4);
  const int ring_at = w * B16_RING_BYTES / 4;  // a warp's ring, in words
  const int ml0 = blockIdx.x * L;  // the tile's first minibatch lane
  const int lane0 = A.perm[ml0 / A.rbl] * A.rbl + ml0 % A.rbl;
  const int x_rows = CNN ? CNN_H : net.enc_rows;
  const int RX = OBS_DIM + x_rows + H;  // rows of the XS scratch
  const int h_row = OBS_DIM + x_rows;   // h_in's first row there
  const uint4* PG = reinterpret_cast<const uint4*>(A.PG);
  const uint2* PGT = reinterpret_cast<const uint2*>(A.PGT);
  int maxw, nbuf;
  enc_buffers(net, maxw, nbuf);
  float ls[4], stdv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ls[k] = A.theta[net.ls_off + k];
    stdv[k] = expf(ls[k]);
  }

  // ---- forward ------------------------------------------------------------
  uint16_t* xb = reinterpret_cast<uint16_t*>(sm);
  uint16_t* hb = xb + Ep * TMB;
  const int Kp = gate_k16(E, H);  // x's and h's rows, then zero rows
  float* obs = sm + Kp * TMB / 2;  // the dense arm's fp32 rows
  float* buf0 = obs + OBS_DIM * L;
  float* buf1 = buf0 + maxw * L;
  float* xf = buf0 + nbuf * maxw * L;
  // the CNN arm's next x, copied (cp.async) while a step runs
  float* xn = sm + Kp * TMB / 2;
  uint32_t* ring =
      reinterpret_cast<uint32_t*>(CNN ? xn + CNN_H * L : obs) + ring_at;
  auto copy_x = [&](int t) {
    const float* xs = A.s[XS] + ((size_t)t * RX + OBS_DIM) * NL + ml0;
    for (int e = tid; e < CNN_H * L / 4; e += blockDim.x) {
      const int k = e / (L / 4), l = 4 * (e % (L / 4));
      cp_async16(xn + k * L + l, xs + (size_t)k * NL + l);
    }
    cp_async_commit();
  };
  if constexpr (CNN) copy_x(0);
  float cr[GATE_PASSES][4][4];
  const float* anc = A.snap + (size_t)A.seg * 2 * H * n + lane0;
#pragma unroll
  for (int p = 0; p < GATE_PASSES; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int u = owned_unit(p, r);
        cr[p][i][r] = u < H ? anc[(size_t)u * n + owned_lane(i, r)] : 0.0f;
      }
  for (int e = tid; e < Hp * L; e += blockDim.x) {
    const int u = e / L, l = e % L;
    hb[u * TMB + l] = u < H ? bf16_bits(anc[(size_t)(H + u) * n + l]) : 0;
  }
  for (int e = tid; e < (Ep - E) * L; e += blockDim.x)
    xb[(E + e / L) * TMB + e % L] = 0;  // x's padded rows
  for (int e = tid; e < (Kp - Ep - Hp) * L; e += blockDim.x)
    hb[(Hp + e / L) * TMB + e % L] = 0;  // K's, to a multiple of 16
  cp_async_wait<0>();  // the CNN arm's first x
  __syncthreads();
  for (int t = 0; t < A.bptt; ++t) {
    const float* pt = A.planes + (size_t)(A.seg * A.bptt + t) * N_TRAJ * n + lane0;
    float* xs = A.s[XS] + (size_t)t * RX * NL + ml0;
    if constexpr (CNN) {
      // x, the tower's output, copied from the scratch during the last step
#pragma unroll 8
      for (int e = tid; e < CNN_H * L; e += blockDim.x) {
        const int k = e / L, l = e % L;
        xb[k * TMB + l] = bf16_bits(xn[k * L + l]);
      }
    } else {
      // with no encoder the obs are x's rows
      for (int e = tid; e < OBS_DIM * L; e += blockDim.x) {
        const int k = e / L, l = e % L;
        const float v = pt[(size_t)(TP_OBS0 + k) * n + l];
        xs[(size_t)k * NL + l] = v;
        if (net.n_enc)
          obs[k * L + l] = v;
        else
          xb[k * TMB + l] = bf16_bits(v);
      }
    }
    for (int e = tid; e < H * L; e += blockDim.x) {
      const int u = e / L, l = e % L;
      xs[(size_t)(h_row + u) * NL + l] = b16_value(hb[u * TMB + l]);
    }
    __syncthreads();
    if (CNN && t + 1 < A.bptt) copy_x(t + 1);
    if (!CNN && net.n_enc) {
      lstm_encoder<L, L, L, true>(
          obs, buf0, buf1, xf, A.theta, net,
          [&](int i, const float* out, int os) {
            int r0 = OBS_DIM;
            for (int j = 0; j < i; ++j) r0 += net.enc_w[j];
            const bool last = i == net.n_enc - 1;
            for (int e = tid; e < net.enc_w[i] * L; e += blockDim.x) {
              const int k = e / L, l = e % L;
              const float v = out[k * os + l];
              xs[(size_t)(r0 + k) * NL + l] = v;
              if (last) xb[k * TMB + l] = bf16_bits(v);
            }
          });
      __syncthreads();
    }
    float* gfs = A.s[GF] + (size_t)t * GF_B16 * Hp * NL +
                 (size_t)ml0 * GF_B16 * Hp;
    float* h2s = A.s[H2S] + (size_t)t * H * NL + ml0;
    lstm_gates_b16(xb, hb, E, H, PG, A.BP, reinterpret_cast<uint4*>(ring),
                   [&](int p, int i, int r, int u, int l, float gi, float gf,
                       float gg, float go) {
                     const float cin = cr[p][i][r];
                     const float c2 = gf * cin + gi * gg;
                     cr[p][i][r] = c2;
                     const float h2 = go * tanhf(c2);
                     const float q5[GF_B16] = {gi, gf, gg, go, cin};
#pragma unroll
                     for (int q = 0; q < GF_B16; ++q)
                       gfs[gf_at<GF_B16>(p, i, q, r)] = q5[q];
                     if (u < H) h2s[(size_t)u * NL + l] = h2;
                     return h2;
                   });
    __syncthreads();
    // the heads at h' (to the DMV scratch), then _mask_carry
    const float* done = pt + (size_t)TP_DONE * n;
    {
      float m[4], v;
      heads4_b16(hb, A.theta, net, m, v);
      const int l = tid >> 2;
      if ((tid & 3) == 0) {
        float* mvs = A.s[DMV] + (size_t)t * 5 * NL + ml0 + l;
#pragma unroll
        for (int k = 0; k < 4; ++k) mvs[(size_t)k * NL] = m[k];
        mvs[(size_t)4 * NL] = v;
      }
      const float keep = 1.0f - done[l];
      for (int u = tid & 3; u < H; u += 4) {
        uint16_t* hv = hb + u * TMB + l;
        *hv = bf16_bits(b16_value(*hv) * keep);
      }
    }
#pragma unroll
    for (int p = 0; p < GATE_PASSES; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cr[p][i][r] = cr[p][i][r] * (1.0f - done[owned_lane(i, r)]);
    cp_async_wait<0>();  // the CNN arm's next x
    __syncthreads();
  }

  // ---- backward through time ---------------------------------------------
  uint16_t* dzb = reinterpret_cast<uint16_t*>(sm);  // 4 Hp bf16 rows
  ring = reinterpret_cast<uint32_t*>(sm + 4 * Hp * TMB / 2) + ring_at;
  const int dz_end = 4 * Hp * TMB / 2 + WALK_RING_FLOATS;
  const int dz_floats = dz_end > maxw * S ? dz_end : maxw * S;
  float* dx = sm + dz_floats;
  float* dmv = dx + dx_rows(net, ENC) * S;
  float* keep_s = dmv + 5 * S;
  float dh[GATE_PASSES][4][4], dc[GATE_PASSES][4][4];
  zero_frags(dh);
  zero_frags(dc);
  float stv[N_UPSTATS];
#pragma unroll
  for (int k = 0; k < N_UPSTATS; ++k) stv[k] = 0.0f;
  const float* hw = A.theta + net.head_off;
  const float* vw = A.theta + net.vhead_off;
  const bool want_dx = CNN || net.n_enc;
  for (int t = A.bptt - 1; t >= 0; --t) {
    const int ts = A.seg * A.bptt + t;
    const float* pt = A.planes + (size_t)ts * N_TRAJ * n + lane0;
    const float* xs = A.s[XS] + (size_t)t * RX * NL + ml0;
    float* gs = A.s[GZ] + (size_t)t * 4 * H * NL + ml0;
    const float* gfs = A.s[GF] + (size_t)t * GF_B16 * Hp * NL +
                       (size_t)ml0 * GF_B16 * Hp;
    if (tid < L) {
      float m[4], a[4], dm[4], g_v, st[N_UPSTATS];
      float* dmvs = A.s[DMV] + (size_t)t * 5 * NL + ml0 + tid;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m[k] = dmvs[(size_t)k * NL];
        a[k] = pt[(size_t)(TP_ACT0 + k) * n + tid];
      }
      const float v = dmvs[(size_t)4 * NL];
      const float* ar = A.advret + (size_t)ts * n + lane0 + tid;
      head_grads(m, v, a, pt[(size_t)TP_LOGP * n + tid],
                 pt[(size_t)TP_VAL * n + tid], ar[0],
                 ar[(size_t)A.T * n], ls, stdv, co, dm, g_v, st);
#pragma unroll
      for (int k = 0; k < N_UPSTATS; ++k) stv[k] = stv[k] + st[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dmv[k * S + tid] = op_value<true>(dm[k]);  // dh2's operand
        dmvs[(size_t)k * NL] = dm[k];
      }
      dmv[4 * S + tid] = op_value<true>(g_v);
      dmvs[(size_t)4 * NL] = g_v;
      keep_s[tid] = 1.0f - pt[(size_t)TP_DONE * n + tid];
    }
    __syncthreads();
    // through the cell, on the pairs this thread owns: dz to the GZ scratch
    // (gate g of unit u at row g H + u) and as bf16 rows
#pragma unroll
    for (int p = 0; p < GATE_PASSES; ++p) {
      const int ug = w + GATE_WARPS * p;
      if (ug >= UG) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float st5[GF_B16][4], z[4][4];
#pragma unroll
        for (int q = 0; q < GF_B16; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) st5[q][r] = gfs[gf_at<GF_B16>(p, i, q, r)];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int u = owned_unit(p, r), l = owned_lane(i, r);
#pragma unroll
          for (int g = 0; g < 4; ++g) z[r][g] = 0.0f;
          if (u < H) {
            const float keep = keep_s[l];
            float hd = __ldg(hw + u) * dmv[l];
#pragma unroll
            for (int k = 1; k < 4; ++k)
              hd = __fmaf_rn(__ldg(hw + k * H + u), dmv[k * S + l], hd);
            const float dh2 =
                (hd + __ldg(vw + u) * dmv[4 * S + l]) + dh[p][i][r] * keep;
            const float gi = st5[0][r], gf = st5[1][r], gg = st5[2][r];
            const float go = st5[3][r], cin = st5[4][r];
            const float th = tanhf(gf * cin + gi * gg);  // the forward's
            const float dc2 = dc[p][i][r] * keep + dh2 * go * (1.0f - th * th);
            const float dgo = dh2 * th;
            const float dgi = dc2 * gg;
            const float dgf = dc2 * cin;
            const float dgg = dc2 * gi;
            dc[p][i][r] = dc2 * gf;
            z[r][0] = dgi * (gi * (1.0f - gi));
            z[r][1] = dgf * (gf * (1.0f - gf));
            z[r][2] = dgg * (1.0f - gg * gg);
            z[r][3] = dgo * (go * (1.0f - go));
#pragma unroll
            for (int g = 0; g < 4; ++g) gs[(size_t)(g * H + u) * NL + l] = z[r][g];
          }
#pragma unroll
          for (int g = 0; g < 4; ++g)
            dzb[(32 * ug + 8 * g + u % 8) * TMB + l] = bf16_bits(z[r][g]);
        }
      }
    }
    __syncthreads();
    // [dx; dh] = dz [Wi; Wh]^T: dh into this thread's registers
    gates_bwd_b16(dzb, E, H, PGT, want_dx, dx, reinterpret_cast<uint2*>(ring),
                  dh);
    __syncthreads();
    if constexpr (CNN) {
      // the trunk's relu: dzt = dx * (x > 0) to the scratch, four lanes a
      // thread, every x loaded before any store
      float* dzs = A.s[DP] + (size_t)t * E * NL + ml0;
      constexpr int PER = CNN_H * L / 4 / LSTM_THREADS;
      float4 xv[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int e = tid + LSTM_THREADS * j;
        xv[j] = *reinterpret_cast<const float4*>(
            xs + (size_t)(OBS_DIM + e / (L / 4)) * NL + 4 * (e % (L / 4)));
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int e = tid + LSTM_THREADS * j, k = e / (L / 4);
        const int l = 4 * (e % (L / 4));
        const float4 dv = *reinterpret_cast<const float4*>(dx + k * S + l);
        *reinterpret_cast<float4*>(dzs + (size_t)k * NL + l) = make_float4(
            dv.x * (xv[j].x > 0.0f ? 1.0f : 0.0f),
            dv.y * (xv[j].y > 0.0f ? 1.0f : 0.0f),
            dv.z * (xv[j].z > 0.0f ? 1.0f : 0.0f),
            dv.w * (xv[j].w > 0.0f ? 1.0f : 0.0f));
      }
      continue;
    }
    // the encoder backward: dpre = dx (1 - y^2), then dx of the layer below
    float* d = dx;
    for (int i = net.n_enc - 1; i >= 0; --i) {
      int r0 = 0;
      for (int j = 0; j < i; ++j) r0 += net.enc_w[j];
      float* dps = A.s[DP] + ((size_t)t * net.enc_rows + r0) * NL + ml0;
      // four lanes a thread, four float4s of y loaded before any store
      const int n4 = net.enc_w[i] * (L / 4);
      for (int e0 = tid; e0 < n4; e0 += 4 * LSTM_THREADS) {
        float4 yv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e0 + LSTM_THREADS * j;
          if (e < n4)
            yv[j] = *reinterpret_cast<const float4*>(
                xs + (size_t)(OBS_DIM + r0 + e / (L / 4)) * NL +
                4 * (e % (L / 4)));
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = e0 + LSTM_THREADS * j, k = e / (L / 4);
          const int l = 4 * (e % (L / 4));
          if (e >= n4) break;
          const float4 dv = *reinterpret_cast<const float4*>(d + k * S + l);
          const float4 dp = make_float4(dv.x * (1.0f - yv[j].x * yv[j].x),
                                        dv.y * (1.0f - yv[j].y * yv[j].y),
                                        dv.z * (1.0f - yv[j].z * yv[j].z),
                                        dv.w * (1.0f - yv[j].w * yv[j].w));
          // dense_t's operand
          *reinterpret_cast<float4*>(d + k * S + l) = make_float4(
              op_value<true>(dp.x), op_value<true>(dp.y),
              op_value<true>(dp.z), op_value<true>(dp.w));
          *reinterpret_cast<float4*>(dps + (size_t)k * NL + l) = dp;
        }
      }
      __syncthreads();
      if (i > 0) {
        float* d2 = d == dx ? sm : dx;  // dz's rows are free once the product ran
        dense_t<L, S>(A.theta + net.enc_off[i], net.enc_w[i], net.enc_w[i - 1],
                      d, d2);
        __syncthreads();
        d = d2;
      }
    }
  }

  // this block's 8 stat sums, lanes in order
  float* red = sm;
  if (tid < L)
#pragma unroll
    for (int k = 0; k < N_UPSTATS; ++k) red[k * L + tid] = stv[k];
  __syncthreads();
  if (tid < N_UPSTATS) {
    float s = 0.0f;
    for (int l = 0; l < L; ++l) s = s + red[tid * L + l];
    A.stat_part[(size_t)blockIdx.x * N_UPSTATS + tid] = s;
  }
}

// A.theta: under BF16 round_weights_kernel's copy.
template <int ENC, bool BF16>
__global__ void __launch_bounds__(LSTM_THREADS, 1)
bptt_kernel(BpttArgs A, LstmNet net, UConsts co) {
  if constexpr (BF16) {
    bptt_walk_b16<ENC>(A, net, co);
    return;
  }
  constexpr bool CNN = ENC == ENC_CNN;
  constexpr int L = BP_LANES, S = TM_S;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int H = net.H, E = net.E, n = A.n, NL = A.NL, tid = threadIdx.x;
  const int Hp = gate_units(H), Ep = gate_inputs(E), UG = Hp / 8;
  const int w = tid >> 5;
  const int ml0 = blockIdx.x * L;  // the tile's first minibatch lane
  const int lane0 = A.perm[ml0 / A.rbl] * A.rbl + ml0 % A.rbl;
  // the XS scratch: [obs, the encoder's outputs (the CNN's x), h_in]
  const int x_rows = CNN ? CNN_H : net.enc_rows;
  const int RX = OBS_DIM + x_rows + H;  // rows of the XS scratch
  const int h_row = OBS_DIM + x_rows;   // h_in's first row there
  float ls[4], stdv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ls[k] = A.theta[net.ls_off + k];
    stdv[k] = expf(ls[k]);
  }

  // ---- forward: the segment from its anchor, activations to the scratch --
  // dense: the obs rows and the encoder's buffers (stride L) before x;
  // CNN: x alone (tower_fwd_kernel wrote it to the scratch); then h
  float *obs, *buf0, *buf1, *x;
  if constexpr (CNN) {
    obs = buf0 = buf1 = nullptr;
    x = sm;
  } else {
    int maxw, nbuf;
    enc_buffers(net, maxw, nbuf);
    obs = sm;
    buf0 = obs + OBS_DIM * L;
    buf1 = buf0 + maxw * L;
    x = buf0 + nbuf * maxw * L;
  }
  float* h = x + Ep * S;
  // with no encoder the obs are x's rows
  float* obs_rows = net.n_enc ? obs : x;
  const int obs_s = net.n_enc ? L : S;
  // c of the (lane, unit) pairs this thread owns in the gate block
  float cr[GATE_PASSES][4][4];
  const float* anc = A.snap + (size_t)A.seg * 2 * H * n + lane0;
#pragma unroll
  for (int p = 0; p < GATE_PASSES; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int u = owned_unit(p, r);
        cr[p][i][r] = u < H ? anc[(size_t)u * n + owned_lane(i, r)] : 0.0f;
      }
  for (int e = tid; e < Hp * L; e += blockDim.x) {
    const int u = e / L, l = e % L;
    h[u * S + l] = u < H ? anc[(size_t)(H + u) * n + l] : 0.0f;
  }
  for (int e = tid; e < (Ep - E) * L; e += blockDim.x)
    x[(E + e / L) * S + e % L] = 0.0f;  // x's padded rows
  __syncthreads();
  for (int t = 0; t < A.bptt; ++t) {
    const float* pt = A.planes + (size_t)(A.seg * A.bptt + t) * N_TRAJ * n + lane0;
    float* xs = A.s[XS] + (size_t)t * RX * NL + ml0;
    if constexpr (CNN) {
      // x, the tower's output, from the scratch
#pragma unroll 8
      for (int e = tid; e < CNN_H * L; e += blockDim.x) {
        const int k = e / L, l = e % L;
        x[k * S + l] = xs[(size_t)(OBS_DIM + k) * NL + l];
      }
    } else {
      for (int e = tid; e < OBS_DIM * L; e += blockDim.x) {
        const int k = e / L, l = e % L;
        const float v = pt[(size_t)(TP_OBS0 + k) * n + l];
        obs_rows[k * obs_s + l] = v;
        xs[(size_t)k * NL + l] = v;
      }
    }
    for (int e = tid; e < H * L; e += blockDim.x) {
      const int u = e / L, l = e % L;
      xs[(size_t)(h_row + u) * NL + l] = h[u * S + l];
    }
    __syncthreads();
    if constexpr (!CNN) {
      lstm_encoder<L, L, S>(obs, buf0, buf1, x, A.theta, net,
                            [&](int i, const float* out, int os) {
                              int r0 = OBS_DIM;
                              for (int j = 0; j < i; ++j) r0 += net.enc_w[j];
                              for (int e = tid; e < net.enc_w[i] * L;
                                   e += blockDim.x) {
                                const int k = e / L, l = e % L;
                                xs[(size_t)(r0 + k) * NL + l] = out[k * os + l];
                              }
                            });
    }
    float* gfs = A.s[GF] + (size_t)t * 6 * Hp * NL + (size_t)ml0 * 6 * Hp;
    float* h2s = A.s[H2S] + (size_t)t * H * NL + ml0;
    lstm_gates_mma(x, h, E, H, A.PG, A.BP,
                   [&](int p, int i, int r, int u, int l, float gi, float gf,
                       float gg, float go) {
                     const float cin = cr[p][i][r];
                     const float c2 = gf * cin + gi * gg;
                     cr[p][i][r] = c2;
                     const float th = tanhf(c2), h2 = go * th;
                     const float q6[6] = {gi, gf, gg, go, cin, th};
#pragma unroll
                     for (int q = 0; q < 6; ++q) gfs[gf_at(p, i, q, r)] = q6[q];
                     if (u < H) h2s[(size_t)u * NL + l] = h2;
                     return h2;
                   });
    __syncthreads();
    // the heads at h', for the walk back (in the DMV scratch, which it
    // overwrites with their gradients); then _mask_carry with the step's
    // stored done, each thread masking the units of h it read, and c where
    // its owners keep it
    const float* done = pt + (size_t)TP_DONE * n;
    {
      float m[4], v;
      lstm_heads4(h, S, A.theta, net, m, v);
      const int l = tid >> 2;
      if ((tid & 3) == 0) {
        float* mvs = A.s[DMV] + (size_t)t * 5 * NL + ml0 + l;
#pragma unroll
        for (int k = 0; k < 4; ++k) mvs[(size_t)k * NL] = m[k];
        mvs[(size_t)4 * NL] = v;
      }
      const float keep = 1.0f - done[l];
      for (int u = tid & 3; u < H; u += 4) h[u * S + l] = h[u * S + l] * keep;
    }
#pragma unroll
    for (int p = 0; p < GATE_PASSES; ++p)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cr[p][i][r] = cr[p][i][r] * (1.0f - done[owned_lane(i, r)]);
    __syncthreads();
  }

  // ---- backward through time ---------------------------------------------
  float* dz = sm;  // 4 Hp rows in the gate block's column order
  float* dx = dz + 4 * Hp * S;
  float* dmv = dx + dx_rows(net, ENC) * S;
  float* keep_s = dmv + 5 * S;
  // dh and dc of the pairs this thread owns
  float dh[GATE_PASSES][4][4], dc[GATE_PASSES][4][4];
  zero_frags(dh);
  zero_frags(dc);
  float stv[N_UPSTATS];
#pragma unroll
  for (int k = 0; k < N_UPSTATS; ++k) stv[k] = 0.0f;
  const float* hw = A.theta + net.head_off;
  const float* vw = A.theta + net.vhead_off;
  // no encoder: x is data, no dx
  const bool want_dx = CNN || net.n_enc;
  for (int t = A.bptt - 1; t >= 0; --t) {
    const int ts = A.seg * A.bptt + t;
    const float* pt = A.planes + (size_t)ts * N_TRAJ * n + lane0;
    const float* xs = A.s[XS] + (size_t)t * RX * NL + ml0;
    float* gs = A.s[GZ] + (size_t)t * 4 * H * NL + ml0;
    const float* gfs =
        A.s[GF] + (size_t)t * 6 * Hp * NL + (size_t)ml0 * 6 * Hp;
    if (tid < L) {
      // the PPO surrogate's gradients (K3's _head_grads) at the heads the
      // forward kept
      float m[4], a[4], dm[4], g_v, st[N_UPSTATS];
      float* dmvs = A.s[DMV] + (size_t)t * 5 * NL + ml0 + tid;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m[k] = dmvs[(size_t)k * NL];
        a[k] = pt[(size_t)(TP_ACT0 + k) * n + tid];
      }
      const float v = dmvs[(size_t)4 * NL];
      const float* ar = A.advret + (size_t)ts * n + lane0 + tid;
      head_grads(m, v, a, pt[(size_t)TP_LOGP * n + tid],
                 pt[(size_t)TP_VAL * n + tid], ar[0],
                 ar[(size_t)A.T * n], ls, stdv, co, dm, g_v, st);
#pragma unroll
      for (int k = 0; k < N_UPSTATS; ++k) stv[k] = stv[k] + st[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dmv[k * S + tid] = dm[k];
        dmvs[(size_t)k * NL] = dm[k];
      }
      dmv[4 * S + tid] = g_v;
      dmvs[(size_t)4 * NL] = g_v;
      keep_s[tid] = 1.0f - pt[(size_t)TP_DONE * n + tid];
    }
    __syncthreads();
    // through the cell, on the pairs this thread owns: dh', dc', dz; dc for
    // the step before. A fragment's four pairs load their stored gates
    // together before any arithmetic.
#pragma unroll
    for (int p = 0; p < GATE_PASSES; ++p) {
      const int ug = w + GATE_WARPS * p;
      if (ug >= UG) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float st6[6][4];
#pragma unroll
        for (int q = 0; q < 6; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r) st6[q][r] = gfs[gf_at(p, i, q, r)];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int u = owned_unit(p, r), l = owned_lane(i, r);
          float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          if (u < H) {
            const float keep = keep_s[l];
            float hd = __ldg(hw + u) * dmv[l];
#pragma unroll
            for (int k = 1; k < 4; ++k)
              hd = __fmaf_rn(__ldg(hw + k * H + u), dmv[k * S + l], hd);
            const float dh2 =
                (hd + __ldg(vw + u) * dmv[4 * S + l]) + dh[p][i][r] * keep;
            const float gi = st6[0][r], gf = st6[1][r], gg = st6[2][r];
            const float go = st6[3][r], cin = st6[4][r], th = st6[5][r];
            const float dc2 = dc[p][i][r] * keep + dh2 * go * (1.0f - th * th);
            const float dgo = dh2 * th;
            const float dgi = dc2 * gg;
            const float dgf = dc2 * cin;
            const float dgg = dc2 * gi;
            dc[p][i][r] = dc2 * gf;
            z[0] = dgi * (gi * (1.0f - gi));
            z[1] = dgf * (gf * (1.0f - gf));
            z[2] = dgg * (1.0f - gg * gg);
            z[3] = dgo * (go * (1.0f - go));
          }
#pragma unroll
          for (int g = 0; g < 4; ++g)
            dz[(32 * ug + 8 * g + u % 8) * S + l] = z[g];
        }
      }
    }
    __syncthreads();
    // [dx; dh] = dz [Wi; Wh]^T: dh into this thread's registers; beside it
    // dz's rows to the GZ scratch (natural order: gate g of unit u at row
    // g H + u), 256 contiguous bytes a row
    gates_bwd_mma(dz, E, H, A.PGT, want_dx, dx, dh);
    for (int e = tid; e < 4 * H * (L / 4); e += blockDim.x) {
      const int row = e / (L / 4), l4 = 4 * (e % (L / 4));
      const int g = row / H, u = row % H;
      *reinterpret_cast<float4*>(gs + (size_t)row * NL + l4) =
          *reinterpret_cast<const float4*>(
              dz + (32 * (u / 8) + 8 * g + u % 8) * S + l4);
    }
    __syncthreads();
    if constexpr (CNN) {
      // the trunk's relu: dzt = dx * (x > 0) to the scratch; the conv
      // backward runs after the segment (tower_bwd_kernel)
      float* dzs = A.s[DP] + (size_t)t * E * NL + ml0;
#pragma unroll 8
      for (int e = tid; e < CNN_H * L; e += blockDim.x) {
        const int k = e / L, l = e % L;
        const float xv = xs[(size_t)(OBS_DIM + k) * NL + l];
        dzs[(size_t)k * NL + l] = dx[k * S + l] * (xv > 0.0f ? 1.0f : 0.0f);
      }
      continue;
    }
    // the encoder backward: dpre = dx (1 - y^2), then dx of the layer below
    float* d = dx;
    for (int i = net.n_enc - 1; i >= 0; --i) {
      int r0 = 0;
      for (int j = 0; j < i; ++j) r0 += net.enc_w[j];
      float* dps = A.s[DP] + ((size_t)t * net.enc_rows + r0) * NL + ml0;
#pragma unroll 4
      for (int e = tid; e < net.enc_w[i] * L; e += blockDim.x) {
        const int k = e / L, l = e % L;
        const float y = xs[(size_t)(OBS_DIM + r0 + k) * NL + l];
        const float dp = d[k * S + l] * (1.0f - y * y);
        d[k * S + l] = dp;
        dps[(size_t)k * NL + l] = dp;
      }
      __syncthreads();
      if (i > 0) {
        float* d2 = d == dx ? dz : dx;  // dz is free once the product ran
        dense_t<L, S>(A.theta + net.enc_off[i], net.enc_w[i], net.enc_w[i - 1],
                      d, d2);
        __syncthreads();
        d = d2;
      }
    }
  }

  // this block's 8 stat sums, lanes in order
  float* red = dz;
  if (tid < L)
#pragma unroll
    for (int k = 0; k < N_UPSTATS; ++k) red[k * L + tid] = stv[k];
  __syncthreads();
  if (tid < N_UPSTATS) {
    float s = 0.0f;
    for (int l = 0; l < L; ++l) s = s + red[tid * L + l];
    A.stat_part[(size_t)blockIdx.x * N_UPSTATS + tid] = s;
  }
}

// The CNN arm's tower forward over one segment's samples, before its walk
// through time: fixed tiles of 64 samples (lanes ml0 .. of step tl) taken
// by block b in the order b, b + G, ...; per tile the obs to the XS
// scratch and their splat scalars, cnn_mma.cuh's tower_fwd_tile with each
// window's conv1 output to the X2S scratch, then x = relu(trunk + bt) to
// the XS rows OBS_DIM .. OBS_DIM + 128.
struct TowerFwdArgs {
  const float* planes;  // (T, 21, n)
  const int* perm;      // (n_sel,) row blocks of the minibatch
  const float* theta;
  const float4* pk;     // packed weights (cnn_mma.cuh PK_*)
  const float* grid;
  float* xs;            // the XS scratch (bptt, RX, NL)
  float* x2s;           // the X2S scratch (bptt, 576, NL)
  int n, rbl, t0, RX, NL, n_tiles;
};

template <bool BF16>
__global__ void __launch_bounds__(TM_THREADS, 2)
tower_fwd_kernel(TowerFwdArgs A) {
  constexpr int L = TM_L, S = TM_S;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sp = tf_rows<BF16>(sm) + TF_SP * S;  // TFB_SP too
  const float* hh = tf_h<BF16>(sm);
  const int tid = threadIdx.x, n = A.n, NL = A.NL, per_t = NL / L;
  tower_load_w0<BF16>(sm, A.pk);  // before the first tile's barriers
  for (int tau = blockIdx.x; tau < A.n_tiles; tau += gridDim.x) {
    const int tl = tau / per_t, ml0 = (tau % per_t) * L;
    const int lane0 = A.perm[ml0 / A.rbl] * A.rbl + ml0 % A.rbl;
    const float* pt = A.planes + (size_t)(A.t0 + tl) * N_TRAJ * n + lane0;
    float* xs = A.xs + (size_t)tl * A.RX * NL + ml0;
    float* x2s = A.x2s + (size_t)tl * CNN_X2 * NL + ml0;
    __syncthreads();  // the last tile's readers are done
    if (tid < L) {
      float o[OBS_DIM], s12[12];
#pragma unroll
      for (int k = 0; k < OBS_DIM; ++k) {
        o[k] = pt[(size_t)(TP_OBS0 + k) * n + tid];
        xs[(size_t)k * NL + tid] = o[k];
      }
      splat12(o, s12);
#pragma unroll
      for (int k = 0; k < 12; ++k) sp[k * S + tid] = s12[k];
    }
    __syncthreads();
    tower_forward<BF16>(sm, A.theta, A.pk, A.grid,
                        [&](int q1, const float* y1) {
      if constexpr (BF16) {  // a float4 a thread
        for (int e = tid; e < CNN_C1 * L / 4; e += blockDim.x) {
          const int o = e / (L / 4), l = 4 * (e % (L / 4));
          *reinterpret_cast<float4*>(x2s + (size_t)(q1 * CNN_C1 + o) * NL +
                                     l) =
              *reinterpret_cast<const float4*>(y1 + o * S + l);
        }
      } else {
        for (int e = tid; e < CNN_C1 * L; e += blockDim.x) {
          const int o = e / L, l = e % L;
          x2s[(size_t)(q1 * CNN_C1 + o) * NL + l] = y1[o * S + l];
        }
      }
    });
    __syncthreads();
    for (int e = tid; e < CNN_H * L; e += blockDim.x) {
      const int k = e / L, l = e % L;
      xs[(size_t)(OBS_DIM + k) * NL + l] = hh[k * S + l];
    }
  }
}

// One product of the weight gradients over a segment's samples, on the
// tensor cores in 3xTF32: C (M x N) = sum_s A[m][s] B[n][s], and with
// blockIdx.y == 0 the bias sums sum_s A[m][s] as column N (fp32). A and B
// are scratch buffers (bptt, rows, NL) from rows a0 / b0; sample s = t * NL
// + lane. Block (i, j, kc) takes the 64 x 64 tile (i, j) over chunk kc of
// CK lanes of one step and writes its own partial row (row0 + kc) of the
// (rows, ptot) buffer at out_off, the block (M, N + 1) row-major. BF16: on
// the bf16 tensor cores (mma.cuh grad_b16_tile: each window's operands
// rounded once into bf16 rows, m16n8k16 products, GB_SMEM bytes); the bias
// sums of the operands as they are.
struct GemmPair {
  const float* a;
  int ra, a0, M;
  const float* b;
  int rb, b0, N;
  int out_off;
};

// The fp32 products' tile on the TF32 instruction in 3xTF32.
__device__ __forceinline__ void grad_tf32_tile(const GemmPair& p, int NL,
                                               int CK,
                                               float* __restrict__ partial,
                                               int ptot, int row0) {
  // Per window of 64 samples each thread stores the float4s of A and B it
  // loaded during the last window into one of two buffers, so one barrier
  // a window. Warp w takes rows 32 (w & 1) .., columns 16 (w >> 1) .. of
  // the tile: 2 x 2 fragments.
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * GM_T, n0 = blockIdx.y * GM_T, kc = blockIdx.z;
  const int per_t = NL / CK;
  const int t = kc / per_t, lane0 = (kc % per_t) * CK;
  const float* a = p.a + ((size_t)t * p.ra + p.a0) * NL + lane0;
  const float* b = p.b + ((size_t)t * p.rb + p.b0) * NL + lane0;
  const bool bias = blockIdx.y == 0;
  const int wm = 32 * (w & 1), wn = 16 * (w >> 1);
  float sum[2][2][4], bsum = 0.0f;
  zero_frags(sum);
  // this thread's float4s of a window: element e = tid + 256 q, row e / 16,
  // samples 4 (e % 16) ..
  constexpr int NQ = GM_T * GM_T / 4 / 256;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 ra[NQ], rb[NQ];
  auto load = [&](int s0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int e = tid + 256 * q, row = e / 16, col = 4 * (e % 16);
      ra[q] = m0 + row < p.M
                  ? __ldg(reinterpret_cast<const float4*>(
                        a + (size_t)(m0 + row) * NL + s0 + col))
                  : zero4;
      rb[q] = n0 + row < p.N
                  ? __ldg(reinterpret_cast<const float4*>(
                        b + (size_t)(n0 + row) * NL + s0 + col))
                  : zero4;
    }
  };
  load(0);
  int buf = 0;
  for (int s0 = 0; s0 < CK; s0 += GM_T) {
    float* As = sm + buf * 2 * GM_T * GM_S;
    float* Bs = As + GM_T * GM_S;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int e = tid + 256 * q, row = e / 16, col = 4 * (e % 16);
      *reinterpret_cast<float4*>(As + row * GM_S + col) = ra[q];
      *reinterpret_cast<float4*>(Bs + row * GM_S + col) = rb[q];
    }
    __syncthreads();
    if (s0 + GM_T < CK) load(s0 + GM_T);
    // the window's sums in fresh accumulators, folded into the chunk's
    float acc[2][2][4];
    zero_frags(acc);
#pragma unroll
    for (int k0 = 0; k0 < GM_T; k0 += 8) {
      uint32_t ab[2][4], as[2][4], bb[2][2], bs[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* pa = As + (wm + 16 * i + g) * GM_S + k0 + tq;
        split_tf32(pa[0], ab[i][0], as[i][0]);
        split_tf32(pa[8 * GM_S], ab[i][1], as[i][1]);
        split_tf32(pa[4], ab[i][2], as[i][2]);
        split_tf32(pa[8 * GM_S + 4], ab[i][3], as[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* pb = Bs + (wn + 8 * j + g) * GM_S + k0 + tq;
        split_tf32(pb[0], bb[j][0], bs[j][0]);
        split_tf32(pb[4], bb[j][1], bs[j][1]);
      }
      mma3(acc, ab, as, bb, bs);
    }
    fold(sum, 0, acc);
    if (bias) {
#pragma unroll 1
      for (int r = 0; r < 8; ++r) {
        const float v = row_sum(As + (8 * w + r) * GM_S);
        if (lane == r) bsum = bsum + v;
      }
    }
    buf ^= 1;  // the other buffer's last readers passed this window's barrier
  }
  float* out = partial + (size_t)(row0 + kc) * ptot + p.out_off;
  const int W = p.N + 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + 16 * i + g + (r & 2 ? 8 : 0);
        const int c = n0 + wn + 8 * j + 2 * tq + (r & 1);
        if (m < p.M && c < p.N) out[(size_t)m * W + c] = sum[i][j][r];
      }
  if (bias && lane < 8 && m0 + 8 * w + lane < p.M)
    out[(size_t)(m0 + 8 * w + lane) * W + p.N] = bsum;
}


template <bool BF16>
__global__ void __launch_bounds__(256, 2)
grad_mma_kernel(GemmPair p, int NL, int CK, float* __restrict__ partial,
                int ptot, int row0) {
  if constexpr (BF16) {
    extern __shared__ float4 smem4[];
    const int kc = blockIdx.z, per_t = NL / CK;
    const int t = kc / per_t, lane0 = (kc % per_t) * CK;
    grad_b16_tile(p.a + ((size_t)t * p.ra + p.a0) * NL + lane0,
                  p.b + ((size_t)t * p.rb + p.b0) * NL + lane0, p.M, p.N, NL,
                  CK, blockIdx.x * GM_T, blockIdx.y * GM_T, blockIdx.y == 0,
                  reinterpret_cast<uint16_t*>(smem4),
                  partial + (size_t)(row0 + kc) * ptot + p.out_off, p.N + 1);
  } else {
    grad_tf32_tile(p, NL, CK, partial, ptot, row0);
  }
}

// The dense arm's bf16 products (grad_rounded_kernel): grad_tf32_tile
// <true>'s products and folds, bit for bit (one TF32 product a k-step of
// the operands rounded to bf16; their m16n8k16 form, grad_mma_kernel<true>,
// held H12 as closely but moved the one-run bf16 LSTM learning gate's seed-0
// run below its rise, ROADMAP H11), from operands rounded once a window
// into bf16 rows of shared memory. A row holds a window's 64 samples as
// bf16x2 words {s, s + 4} (s % 8 < 4), the word of k-step s / 8 and pair t
// = s % 8 at 8 t + s / 8, GR_S words apart: a thread's eight k-steps are 32
// contiguous bytes, and a quarter warp's 16-byte loads (two rows, four t)
// hit distinct banks. The bias sums read the window's fp32 rows of A, as
// grad_tf32_tile's. GR_SMEM bytes: two windows of A and B, and of A's fp32
// rows.
constexpr int GR_S = 36;
// the fp32 bits of the lower and of the upper bf16 of a bf16x2 word
__device__ __forceinline__ uint32_t b16_lo(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t b16_hi(uint32_t w) {
  return w & 0xffff0000u;
}
constexpr int GR_SMEM = 2 * 2 * GM_T * GR_S * 4 + 2 * GM_T * GM_S * 4;  // 71,680

__global__ void __launch_bounds__(256, 2)
grad_rounded_kernel(GemmPair p, int NL, int CK, float* __restrict__ partial,
                    int ptot, int row0) {
  extern __shared__ float4 smem4[];
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem4);
  float* af = reinterpret_cast<float*>(sw + 2 * 2 * GM_T * GR_S);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * GM_T, n0 = blockIdx.y * GM_T, kc = blockIdx.z;
  const int per_t = NL / CK;
  const int t = kc / per_t, lane0 = (kc % per_t) * CK;
  const float* a = p.a + ((size_t)t * p.ra + p.a0) * NL + lane0;
  const float* b = p.b + ((size_t)t * p.rb + p.b0) * NL + lane0;
  const bool bias = blockIdx.y == 0;
  const int wm = 32 * (w & 1), wn = 16 * (w >> 1);
  float sum[2][2][4], bsum = 0.0f;
  zero_frags(sum);
  // this thread's groups of 8 samples of a window: group e = tid + 256 q,
  // row e / 8, k-step e % 8
  constexpr int NG = GM_T * GM_T / 8 / 256;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 ra[NG][2], rb[NG][2];
  auto load = [&](int s0) {
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const int e = tid + 256 * q, row = e / 8, col = 8 * (e % 8);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ra[q][h] = m0 + row < p.M
                       ? __ldg(reinterpret_cast<const float4*>(
                             a + (size_t)(m0 + row) * NL + s0 + col + 4 * h))
                       : zero4;
        rb[q][h] = n0 + row < p.N
                       ? __ldg(reinterpret_cast<const float4*>(
                             b + (size_t)(n0 + row) * NL + s0 + col + 4 * h))
                       : zero4;
      }
    }
  };
  load(0);
  int buf = 0;
  for (int s0 = 0; s0 < CK; s0 += GM_T) {
    uint32_t* As = sw + buf * 2 * GM_T * GR_S;
    uint32_t* Bs = As + GM_T * GR_S;
    float* Af = af + buf * GM_T * GM_S;
#pragma unroll
    for (int q = 0; q < NG; ++q) {
      const int e = tid + 256 * q, row = e / 8, ks = e % 8;
      uint32_t* pa = As + row * GR_S + ks;
      uint32_t* pb = Bs + row * GR_S + ks;
      pa[0] = bf16x2(ra[q][0].x, ra[q][1].x);
      pa[8] = bf16x2(ra[q][0].y, ra[q][1].y);
      pa[16] = bf16x2(ra[q][0].z, ra[q][1].z);
      pa[24] = bf16x2(ra[q][0].w, ra[q][1].w);
      pb[0] = bf16x2(rb[q][0].x, rb[q][1].x);
      pb[8] = bf16x2(rb[q][0].y, rb[q][1].y);
      pb[16] = bf16x2(rb[q][0].z, rb[q][1].z);
      pb[24] = bf16x2(rb[q][0].w, rb[q][1].w);
      if (bias) {
        *reinterpret_cast<float4*>(Af + row * GM_S + 8 * ks) = ra[q][0];
        *reinterpret_cast<float4*>(Af + row * GM_S + 8 * ks + 4) = ra[q][1];
      }
    }
    __syncthreads();
    if (s0 + GM_T < CK) load(s0 + GM_T);
    // the window's sums in fresh accumulators, folded into the chunk's;
    // k-steps 4 half + c, the words of rows wm + 16 i + g (+ 8) and wn + 8
    // j + g
    float acc[2][2][4];
    zero_frags(acc);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint4 wa[2][2], wb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wa[i][h] = *reinterpret_cast<const uint4*>(
              As + (wm + 16 * i + g + 8 * h) * GR_S + 8 * tq + 4 * half);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wb[j] = *reinterpret_cast<const uint4*>(
            Bs + (wn + 8 * j + g) * GR_S + 8 * tq + 4 * half);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        uint32_t fa[2][4], fb[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t x0 = reinterpret_cast<const uint32_t*>(&wa[i][0])[c];
          const uint32_t x1 = reinterpret_cast<const uint32_t*>(&wa[i][1])[c];
          fa[i][0] = b16_lo(x0);
          fa[i][1] = b16_lo(x1);
          fa[i][2] = b16_hi(x0);
          fa[i][3] = b16_hi(x1);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint32_t y = reinterpret_cast<const uint32_t*>(&wb[j])[c];
          fb[j][0] = b16_lo(y);
          fb[j][1] = b16_hi(y);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) mma_tf32(acc[i][j], fa[i], fb[j]);
      }
    }
    fold(sum, 0, acc);
    if (bias) {
#pragma unroll 1
      for (int r = 0; r < 8; ++r) {
        const float v = row_sum(Af + (8 * w + r) * GM_S);
        if (lane == r) bsum = bsum + v;
      }
    }
    buf ^= 1;  // the other buffer's last readers passed this window's barrier
  }
  float* out = partial + (size_t)(row0 + kc) * ptot + p.out_off;
  const int W = p.N + 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + wm + 16 * i + g + (r & 2 ? 8 : 0);
        const int c = n0 + wn + 8 * j + 2 * tq + (r & 1);
        if (m < p.M && c < p.N) out[(size_t)m * W + c] = sum[i][j][r];
      }
  if (bias && lane < 8 && m0 + 8 * w + lane < p.M)
    out[(size_t)(m0 + 8 * w + lane) * W + p.N] = bsum;
}

// The bf16 arm's copy of the flat buffer (P floats): the weights the walk
// reads on the fp32 cores, each dense encoder layer's W and the heads' W,
// rounded to bf16 (nearest even); every other float (the biases, log_std,
// the gate and tower weights, which the packers round) as it is.
__global__ void round_weights_kernel(const float* __restrict__ theta,
                                     LstmNet net, int P,
                                     float* __restrict__ out) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= P) return;
  bool w = (q >= net.head_off && q < net.head_off + 4 * net.H) ||
           (q >= net.vhead_off && q < net.vhead_off + net.H);
  int nin = OBS_DIM;
  for (int i = 0; i < net.n_enc; ++i) {
    w = w || (q >= net.enc_off[i] && q < net.enc_off[i] + net.enc_w[i] * nin);
    nin = net.enc_w[i];
  }
  const float v = theta[q];
  out[q] = w ? op_value<true>(v) : v;
}

// grads[q] = the sum over the R partial rows of entry map[q] (fixed order);
// log_std's entries (map = -1 - k) and the 8 stat sums from the RS stat
// rows.
__global__ void lstm_reduce_kernel(const float* __restrict__ partial, int R,
                                   int ptot, const int* __restrict__ map,
                                   int P, const float* __restrict__ stat_part,
                                   int RS, float ent_coef,
                                   float* __restrict__ grads,
                                   float* __restrict__ stats) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= P + N_UPSTATS) return;
  const int j = q < P ? map[q] : -1 - (q - P);
  float s = 0.0f;
  if (j >= 0) {
    for (int r = 0; r < R; ++r) s = s + partial[(size_t)r * ptot + j];
    grads[q] = s;
    return;
  }
  const int k = q < P ? 4 + (-1 - j) : q - P;
  for (int r = 0; r < RS; ++r) s = s + stat_part[(size_t)r * N_UPSTATS + k];
  if (q < P)
    grads[q] = s - ent_coef;
  else
    stats[k] = s;
}

}  // namespace drone

// C interface (ctypes). ptrs: host array of device pointers [planes,
// advret, snap, perm, theta, wp, bp, the 7 scratch buffers (XS, GZ, GF, H2,
// DMV, DP, X2S), partial, stat_part, map, grads, stats, pk, grid, pg, pgt,
// theta16]; X2S, the packed tower weights pk (PK_TOTAL float4s, the bf16
// arm's PKB_TOTAL uint4s) and grid
// are the CNN arm's (null for the dense one); pg and pgt room for the gate
// weights' forward and transposed fragments (gate_frags and gate_t_frags
// float4s, the bf16 arm's as many uint32s), written here on the stream;
// theta16 room for the bf16 arm's copy of theta (P floats; null for the
// fp32 arm). layout: lstm.cuh's NET_INTS; encoder: ENC_DENSE or ENC_CNN.
// dims: [n, T, bptt, rbl, NL, CK, P, ptot, n_pairs, the 7 scratch row
// counts, then the shared bytes of a block of the walk, the CNN arm's
// tower forward and backward (0 for the dense arm) and the products
// (tf_smem, tb_smem and GM_SMEM; under bf16 GB_SMEM in the CNN arm,
// GR_SMEM in the dense one), as the wrapper counts them, then bf16: 1 for
// the bf16 operand arm, 0 for 3xTF32]. pairs: n_pairs x [A buffer, A
// row0, M, B buffer, B row0, N, out offset]. consts: [inv_m, clip_lo,
// clip_hi, clip_eps, vf_clip, half_vf_coef, ent_coef]. Returns the
// cudaError_t of the launches.
extern "C" int drone_lstm_update(const uint64_t* ptrs, const int* layout,
                                 int encoder, const int* dims,
                                 const int* pairs, const float* consts,
                                 void* stream) {
  using namespace drone;
  LstmNet net;
  if (!read_net(layout, encoder, net)) return (int)cudaErrorInvalidValue;
  const int n = dims[0], T = dims[1], bptt = dims[2], rbl = dims[3];
  const int NL = dims[4], CK = dims[5], P = dims[6], ptot = dims[7];
  const int n_pairs = dims[8];
  const int* rows = dims + 9;
  const int* smem_bytes = dims + 9 + N_BUFS;
  const int bf16_flag = smem_bytes[4];
  const bool cnn = encoder == ENC_CNN, bf16 = bf16_flag == 1;
  const size_t smem =
      sizeof(float) * (size_t)bptt_smem_floats(net, encoder, bf16);
  const int gsm = !bf16 ? GM_SMEM : (cnn ? GB_SMEM : GR_SMEM);
  if (n <= 0 || bptt <= 0 || T % bptt != 0 || rbl % 128 != 0 ||
      NL % BP_LANES != 0 || CK % GM_T != 0 || NL % CK != 0 || n_pairs <= 0 ||
      smem_bytes[0] != (int)smem ||
      smem_bytes[3] != gsm ||
      rows[GF] != (bf16 ? GF_B16 : 6) * gate_units(net.H) ||
      smem_bytes[1] != (cnn ? tf_smem(bf16) : 0) ||
      smem_bytes[2] != (cnn ? tb_smem(bf16) : 0) || bf16_flag < 0 ||
      bf16_flag > 1 || (bf16 && CK % GB_T != 0) ||
      (cnn && (NL % TM_L != 0 || ptot < OFF_WT ||
               rows[XS] != OBS_DIM + CNN_H + net.H || rows[DP] != CNN_H ||
               rows[X2S] != CNN_X2)))
    return (int)cudaErrorInvalidValue;
  const float** ptr = reinterpret_cast<const float**>(const_cast<uint64_t*>(ptrs));
  BpttArgs A;
  A.planes = ptr[0];
  A.advret = ptr[1];
  A.snap = ptr[2];
  A.perm = reinterpret_cast<const int*>(ptr[3]);
  A.theta = ptr[4];
  const float* wp = ptr[5];
  A.BP = reinterpret_cast<const float4*>(ptr[6]);
  float* bufs[N_BUFS];
  for (int b = 0; b < N_BUFS; ++b) bufs[b] = const_cast<float*>(ptr[7 + b]);
  for (int b = 0; b < N_SCRATCH; ++b) A.s[b] = bufs[b];
  float* partial = const_cast<float*>(ptr[14]);
  float* stat_part = const_cast<float*>(ptr[15]);
  const int* map = reinterpret_cast<const int*>(ptr[16]);
  float* grads = const_cast<float*>(ptr[17]);
  float* stats = const_cast<float*>(ptr[18]);
  float4* pk = reinterpret_cast<float4*>(const_cast<float*>(ptr[19]));
  const float* grid = ptr[20];
  float4* pg = reinterpret_cast<float4*>(const_cast<float*>(ptr[21]));
  float4* pgt = reinterpret_cast<float4*>(const_cast<float*>(ptr[22]));
  float* theta16 = const_cast<float*>(ptr[23]);
  if (pg == nullptr || pgt == nullptr || (bf16 && theta16 == nullptr) ||
      (cnn && (pk == nullptr || grid == nullptr || bufs[X2S] == nullptr)))
    return (int)cudaErrorInvalidValue;
  A.PG = pg;
  A.PGT = pgt;
  A.n = n;
  A.T = T;
  A.bptt = bptt;
  A.rbl = rbl;
  A.NL = NL;
  const UConsts co{consts[0], consts[1], consts[2], consts[3],
                   consts[4], consts[5], consts[6]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* walk = cnn ? (bf16 ? bptt_kernel<ENC_CNN, true>
                          : bptt_kernel<ENC_CNN, false>)
                   : (bf16 ? bptt_kernel<ENC_DENSE, true>
                           : bptt_kernel<ENC_DENSE, false>);
  // the bf16 products: the CNN arm's on the bf16 tensor cores, the dense
  // arm's on the first bf16 design (grad_rounded_kernel)
  auto* gemm = !bf16 ? grad_mma_kernel<false>
                     : (cnn ? grad_mma_kernel<true> : grad_rounded_kernel);
  auto* tfwd = bf16 ? tower_fwd_kernel<true> : tower_fwd_kernel<false>;
  auto* tbwd = bf16 ? tower_bwd_kernel<true> : tower_bwd_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int fsm = tf_smem(bf16), bsm = tb_smem(bf16);
  err = cudaFuncSetAttribute(gemm,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             gsm);
  if (err != cudaSuccess) return (int)err;
  const int S = T / bptt, nblk = NL / BP_LANES, nk = bptt * (NL / CK);
  const int n_tiles = bptt * (NL / TM_L);
  TowerFwdArgs tf{A.planes, A.perm, A.theta, pk, grid, bufs[XS], bufs[X2S],
                  n, rbl, 0, rows[XS], NL, n_tiles};
  TowerBwdArgs tb{bufs[XS], (size_t)rows[XS] * NL, NL, nullptr, rbl, 0,
                  bufs[DP], bufs[X2S], A.theta, pk, grid, partial, ptot, 0,
                  NL, n_tiles};
  const int tf_blocks = n_tiles < TOWER_FWD_BLOCKS ? n_tiles : TOWER_FWD_BLOCKS;
  const int nf = gate_frags(net.E, net.H), nft = gate_t_frags(net.E, net.H);
  if (bf16) {
    const int nw = gate_b16_words(net.E, net.H);
    pack_gates_b16_kernel<<<(nw + 255) / 256, 256, 0, s>>>(
        wp, net.E, net.H, reinterpret_cast<uint32_t*>(pg));
    pack_gates_t_b16_kernel<<<(nft + 255) / 256, 256, 0, s>>>(
        wp, net.E, net.H, reinterpret_cast<uint32_t*>(pgt));
    round_weights_kernel<<<(P + 255) / 256, 256, 0, s>>>(A.theta, net, P,
                                                         theta16);
  } else {
    pack_gates_kernel<<<(nf + 255) / 256, 256, 0, s>>>(wp, net.E, net.H,
                                                       pg);
    pack_gates_t_kernel<<<(nft + 255) / 256, 256, 0, s>>>(wp, net.E, net.H,
                                                          pgt);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (cnn) {
    err = cudaFuncSetAttribute(tfwd,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               fsm);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(tbwd,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bsm);
    if (err != cudaSuccess) return (int)err;
    if (bf16)
      pack_tower_kernel<true><<<(PKB_TOTAL + 255) / 256, 256, 0, s>>>(
          A.theta, pk, PKB_TOTAL);
    else
      pack_tower_kernel<false><<<(PK_TOTAL + 255) / 256, 256, 0, s>>>(
          A.theta, pk, PK_TOTAL);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // the walk reads the weights it multiplies on the fp32 cores rounded (the
  // tower's kernels read theta's biases alone)
  if (bf16) A.theta = theta16;
  for (int seg = 0; seg < S; ++seg) {
    A.seg = seg;
    A.stat_part = stat_part + (size_t)seg * nblk * N_UPSTATS;
    if (cnn) {
      tf.t0 = seg * bptt;
      tfwd<<<tf_blocks, TM_THREADS, fsm, s>>>(tf);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    walk<<<nblk, LSTM_THREADS, smem, s>>>(A, net, co);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (cnn) {
      // one block per product row of the segment (nk <= the tiles)
      tb.row0 = seg * nk;
      tbwd<<<nk, TM_THREADS, bsm, s>>>(tb);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    for (int q = 0; q < n_pairs; ++q) {
      const int* d = pairs + 7 * q;
      const GemmPair gp{bufs[d[0]], rows[d[0]], d[1], d[2],
                        bufs[d[3]], rows[d[3]], d[4], d[5], d[6]};
      const dim3 grid((gp.M + GM_T - 1) / GM_T, (gp.N + GM_T - 1) / GM_T, nk);
      gemm<<<grid, 256, gsm, s>>>(gp, NL, CK, partial, ptot, seg * nk);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  lstm_reduce_kernel<<<(P + N_UPSTATS + 255) / 256, 256, 0, s>>>(
      partial, S * nk, ptot, map, P, stat_part, S * nblk, co.ent_coef, grads,
      stats);
  return (int)cudaGetLastError();
}
