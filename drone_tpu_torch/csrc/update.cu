// update.cu — the PPO update kernels: K3, one minibatch of clipped-PPO
// forward + hand-written backward, and K4, clip_by_global_norm + adam over
// every parameter in one launch.
//
// K3 replaces drone_tpu/ops/pallas_update.py `_update_kernel` (driven by
// `ppo_update`), K4 its `_adam_kernel` (driven by `fused_adam`). Wrappers
// and plain versions: ops/cuda_update.py.
//
// K3 design. A tile is 64 samples: 64 neighbouring lanes of one row block
// (the minibatch's row-block permutation picks the blocks) at one step, so
// each of its trajectory planes is one contiguous 256-byte run. A block of
// 512 threads (one an SM) takes tiles b, b + G, b + 2G, ... for a fixed G
// (at most MAX_BLOCKS), and per tile:
//   - loads the obs rows into shared memory and each thread its sample's
//     head inputs into registers;
//   - runs both towers forward, layer by layer (_tower_fwd): Y = X W^T on
//     the tensor cores, tanh (hidden) or the bias alone (head) on the
//     accumulators, every layer's activations kept in shared memory;
//   - computes the clipped-PPO head gradients and the 8 stat values
//     (_head_grads), four threads a sample (one an action dimension) on
//     half the block's warps, the stats summed by warp butterflies;
//   - back-propagates (_tower_bwd), layer by layer from the head: dW = dY^T
//     X over the tile's samples and db = dY^T 1 (a product with ones), then
//     the input gradient dX = dY W times the tanh derivative over X.
// Every product is mma.sync m16n8k8 in 3xTF32 (mma.cuh), the actor's and
// the critic's units of one layer side by side: a warp takes a unit of 1
// m-tile x 4 n-tiles at a time (16 a layer of 64 x 64). A phase runs on
// every warp; a barrier ends it (10 a tile at two hidden layers). 16 warps
// rather than 8 with units of 2 x 4: 20% faster (PERF.md).
//
// On chip, at [64, 64] (219,040 bytes of shared memory, ONCHIP):
//   - the towers' weights, split once per call into big and small TF32
//     planes by pack_planes_kernel and staged in each block's shared
//     memory: the forward reads W's fragments from them, the input
//     gradient W^T's, from the same planes by index. A layer with an input
//     gradient keeps rows of nin rounded up to 32 floats, element (o, i)
//     at column i ^ swz(o), so both reads are free of bank conflicts;
//     layer 0 (no input gradient) rows of 20 floats, unswizzled;
//   - the activations, rows of the tile's 64 samples, sample s of row r at
//     column s ^ swz(r): the fragments' reads along samples and along rows
//     are free of bank conflicts at 64 floats a row, which keeps every
//     tower the fp32 kernel took (sum of widths <= 436);
//   - the block's running sums of dW and db, rows of W's with the bias in
//     the column after them (a row stride = 8 mod 16: a fragment's float2
//     read-modify-writes are free of bank conflicts). Each tile's window of
//     64 samples is summed in the tensor cores' accumulators from zero and
//     folded in with IEEE adds (H10); each entry is always folded by the
//     same thread, so no atomics (H6). The stat sums stay in registers of
//     threads 0..7.
// A tower too large for that (!ONCHIP) keeps its weight planes and running
// sums in device memory (the planes buffer and a per-block scratch row),
// read and folded through L1 and L2; its activations must fit (update
// layout's envelope). Each block writes its partial row once, in the flat
// buffer's order, and reduce_kernel adds the G rows in block order, so the
// result does not depend on launch order: training on the card is
// deterministic and a resumed run repeats an uninterrupted one bit for bit.
//
// The bf16 arm (compute_dtype="bfloat16", the reference's bf16 operand
// arm of _update_kernel: _tower_fwd's and _tower_bwd's _dot32 round both
// operands of every product to bf16; db is the fp32 sum of dY) is its own
// design, update_kernel<ONCHIP, true> (the section "K3's bf16 arm" below):
// every product on the bf16 tensor cores (m16n8k16) from operands stored
// once as bf16, the weights packed once a call as bf16x2 fragments, the
// next tile's planes copied by cp.async during the current one.
//
// What bounds K3 on an H100: at [64, 64] 29,125 multiply-adds a sample
// (the towers forward, dW and db, dX), 0.19 ms a minibatch at the 3xTF32
// rate (the bf16 arm's at the bf16 rate: 0.04), against 84 bytes of input
// a sample. What holds it: the latency of the phases' short dependent
// chains between barriers and the tanhf on the CUDA cores (PERF.md).
//
// K4 design: one cooperative launch over a grid fixed by the buffer's
// length P alone (min(ceil(P / ADAM_SLICE), 256) blocks of 256 threads,
// each block the fixed slices b, b + G, ... of 2,048 floats read as float4,
// one slice a block up to 524,288 parameters): each block writes its
// slices' sum of squares to a scratch float, the grid meets at one barrier
// (cooperative_groups grid sync: every block is resident), and every warp
// then adds the block sums in block order, so every block scales by the
// same clip factor bit for bit, and updates its slice. The sums' order is
// a function of P alone, so training stays deterministic and a resumed run
// repeats an uninterrupted one bit for bit (H6). The learning rate (linear
// anneal, make_fused_lr) and the bias corrections come from the step
// count, which lives on the device (read by every block before the
// barrier, written by one after it), so no optimizer step waits for the
// host. The formulas are _adam_math's, with bc = 1 - exp(c * log(beta))
// and float32 constants. What bounds it on an H100: its 28 bytes a
// parameter (four buffers read, three written), 1.9 us at the CNN-LSTM's
// 226,697 parameters; at the MLP's 10,441 the launch and the barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma.cuh"
#include "policy.cuh"  // the trajectory-plane layout, UConsts, HALF_LOG_2PI

namespace drone {

constexpr int N_UPSTATS = 8;
constexpr int UPD_HIDDEN = 8;
constexpr int UPD_THREADS = 512;
constexpr int UPD_WARPS = UPD_THREADS / 32;
constexpr int TILE = 64;
constexpr int HEAD_THREADS = 4 * TILE;  // the head: four threads a sample
constexpr int HEAD_WARPS = HEAD_THREADS / 32;
// one block an SM of an H100, 8,192 / 128 = 64 tiles each at hover.toml's
// minibatch. A constant, so the order of the sums never depends on the card.
constexpr int MAX_BLOCKS = 128;
constexpr int SLACK_ROWS = 16;  // read as the padding of the last rows
constexpr int W0_STRIDE = 20;   // = 4 mod 8: layer 0's fragment reads
constexpr int UPD_MAX_SMEM = 232448;
static_assert(UPD_THREADS >= HEAD_THREADS, "the head takes four threads a sample");

__host__ __device__ constexpr int up8(int x) { return (x + 7) & ~7; }
__host__ __device__ constexpr int up16(int x) { return (x + 15) & ~15; }
__host__ __device__ constexpr int up32(int x) { return (x + 31) & ~31; }
// a running-sum row: >= nin + 1 floats (W's row, then the bias), = 8 mod 16
__host__ __device__ constexpr int sums_stride(int nin) {
  return nin + 1 + ((8 - (nin + 1) % 16) + 16) % 16;
}
// the column swizzle of a row r (activations and swizzled weight planes)
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }
// activation (row r, sample s)
__device__ __forceinline__ int ai(int r, int s) { return r * TILE + (s ^ swz(r)); }

// One layer of one tower.
struct MLayer {
  int nin, nout;
  int w;                  // offset of W (nout, nin) in theta; its bias follows
  int wp, sw, swzl;       // its weight planes: offset, row stride, swizzled
  int sb, ss;             // its running sums: offset, row stride
  int in_row, out_row;    // the activation rows of its input and output
};

struct MLayout {
  int L;                  // hidden layers
  int wf;                 // floats of one weight plane (big; small follows)
  int sf;                 // floats of the running sums
  int rows;               // activation rows
  int hm, hv;             // the head outputs' rows: 4 means, 1 value
  MLayer ly[2][UPD_HIDDEN + 1];  // actor, critic; layer L is the head
};

// The layout of towers `width[0..L)` (the flat buffer's W offsets of the
// actor's and the critic's layers in wa, wc); ops/cuda_update.py
// mma_layout mirrors it.
inline void make_layout(int L, const int* width, const int* wa,
                        const int* wc, MLayout& lo) {
  int h = 0;
  for (int l = 0; l < L; ++l) h += width[l];
  lo.L = L;
  lo.hm = OBS_DIM + 2 * h;
  lo.hv = lo.hm + 4;
  lo.rows = lo.hv + 1 + SLACK_ROWS;
  int wp = 0, sb = 0;
  for (int t = 0; t < 2; ++t) {
    const int base = OBS_DIM + t * h;
    int cum = 0, nin = OBS_DIM, in_row = 0;
    for (int l = 0; l <= L; ++l) {
      MLayer& y = lo.ly[t][l];
      y.nin = nin;
      y.nout = l < L ? width[l] : (t == 0 ? 4 : 1);
      y.w = (t == 0 ? wa : wc)[l];
      y.swzl = l > 0;
      y.sw = l > 0 ? up32(nin) : W0_STRIDE;
      y.wp = wp;
      wp += up8(y.nout) * y.sw;
      y.ss = sums_stride(nin);
      y.sb = sb;
      sb += y.nout * y.ss;
      y.in_row = in_row;
      y.out_row = l < L ? base + cum : (t == 0 ? lo.hm : lo.hv);
      in_row = y.out_row;
      cum += y.nout;
      nin = y.nout;
    }
  }
  lo.wf = wp;
  lo.sf = sb;
}

// The stat-sum partials of the head's warps (static shared memory).
constexpr int STAT_PART_BYTES = HEAD_WARPS * N_UPSTATS * 4;

// Shared memory of a block: the activations, then on chip the two weight
// planes and the running sums.
inline size_t layout_smem(const MLayout& lo, bool onchip) {
  return sizeof(float) * ((size_t)lo.rows * TILE +
                          (onchip ? 2 * (size_t)lo.wf + lo.sf : 0));
}

// Every fragment read below advances by whole k-steps of 8 rows or 8
// samples, which leave the swizzle of a row (r & 7) as it is: a lane's
// word offsets are computed once for a unit, and a k-step adds 8 rows
// (8 * TILE words) or XORs 8-multiples into the columns.

// A with M = samples m0.., K = rows r0.. (r0 the absolute row): the lane's
// four offsets at k-step 0.
struct RowsA {
  int o[4];
};
__device__ __forceinline__ RowsA rows_a(int r0, int m0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = r0 + t, m = m0 + g;
  return RowsA{{ai(r, m), ai(r, m + 8), ai(r + 4, m), ai(r + 4, m + 8)}};
}
__device__ __forceinline__ void load_rows_a(const float* act, const RowsA& f,
                                            int k0, uint32_t (&ab)[4],
                                            uint32_t (&as)[4]) {
  const float* p = act + k0 * TILE;
#pragma unroll
  for (int q = 0; q < 4; ++q) split_tf32(p[f.o[q]], ab[q], as[q]);
}

// A with M = rows r0.., K = samples; B with K = samples, N = rows r0..:
// a row's base word and the lane's column XORs ((t ^ swz(r)) and (t + 4 ^
// swz(r))); sample s0 + t of row r is at base + (s0 ^ x).
struct SamplesA {
  int base[2], x[2][2];
};
__device__ __forceinline__ SamplesA samples_a(int r0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  SamplesA f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    f.base[h] = r * TILE;
    f.x[h][0] = t ^ swz(r);
    f.x[h][1] = (t + 4) ^ swz(r);
  }
  return f;
}
__device__ __forceinline__ void load_samples_a(const float* act,
                                               const SamplesA& f, int s0,
                                               uint32_t (&ab)[4],
                                               uint32_t (&as)[4]) {
  split_tf32(act[f.base[0] + (s0 ^ f.x[0][0])], ab[0], as[0]);
  split_tf32(act[f.base[1] + (s0 ^ f.x[1][0])], ab[1], as[1]);
  split_tf32(act[f.base[0] + (s0 ^ f.x[0][1])], ab[2], as[2]);
  split_tf32(act[f.base[1] + (s0 ^ f.x[1][1])], ab[3], as[3]);
}
__device__ __forceinline__ void load_samples_b(const float* act,
                                               const SamplesA& f, int s0,
                                               uint32_t (&bb)[2],
                                               uint32_t (&bs)[2]) {
  split_tf32(act[f.base[0] + (s0 ^ f.x[0][0])], bb[0], bs[0]);
  split_tf32(act[f.base[0] + (s0 ^ f.x[0][1])], bb[1], bs[1]);
}

// B from a layer's weight planes. The forward reads W^T: B[k][n] = W[n][k]
// (element (n0 + g, k0 + t (+4)): the row's base and the column XORs, as
// for samples; layer 0's rows are unswizzled, where k0 ^ (t + 4) = k0 + t
// + 4 all the same). The input gradient reads W: B[k][n] = W[k][n]
// (element (k0 + t (+4), n0 + g): two offsets at k-step 0, a k-step adds 8
// rows).
struct WeightB {
  int o[2], x[2];
};
__device__ __forceinline__ WeightB weight_b_fwd(const MLayer& y, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int o = n0 + g, s = y.swzl ? swz(o) : 0;
  const int base = y.wp + o * y.sw;
  return WeightB{{base, base}, {t ^ s, (t + 4) ^ s}};
}
__device__ __forceinline__ WeightB weight_b_dx(const MLayer& y, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return WeightB{{y.wp + t * y.sw + ((n0 + g) ^ swz(t)),
                  y.wp + (t + 4) * y.sw + ((n0 + g) ^ swz(t + 4))},
                 {0, 0}};
}
// the fragment at k-step k0: the forward's at base + (k0 ^ x), the input
// gradient's at o + k0 sw
template <bool FWD>
__device__ __forceinline__ void load_weight_b(const float* wb,
                                              const float* ws,
                                              const WeightB& f, int k0,
                                              int sw, uint32_t (&bb)[2],
                                              uint32_t (&bs)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = FWD ? f.o[h] + (k0 ^ f.x[h]) : f.o[h] + k0 * sw;
    bb[h] = __float_as_uint(wb[e]);
    bs[h] = __float_as_uint(ws[e]);
  }
}

// acc[i][j] += A_i B_j in 3xTF32 for the unit's valid tiles (i < mv, j <
// nv; the same in every lane).
template <int MI, int NI>
__device__ __forceinline__ void mma3_valid(float (&acc)[MI][NI][4],
                                           const uint32_t (&ab)[MI][4],
                                           const uint32_t (&as)[MI][4],
                                           const uint32_t (&bb)[NI][2],
                                           const uint32_t (&bs)[NI][2],
                                           int mv, int nv) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      if (i < mv && j < nv) mma_tf32(acc[i][j], as[i], bb[j]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      if (i < mv && j < nv) mma_tf32(acc[i][j], ab[i], bs[j]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
      if (i < mv && j < nv) mma_tf32(acc[i][j], ab[i], bb[j]);
}

// A unit of a product: UMI m-tiles x UNI n-tiles; the tile's samples are
// UMP units along M.
constexpr int UMI = 1, UNI = 4;
constexpr int UMP = TILE / 16 / UMI;

// The tiles a phase's units cover: units = 2 towers x mp x ng; unit u's
// tower, m-tile group and n-group.
struct Unit {
  int t, mp, ng;
};
__device__ __forceinline__ Unit unit_of(int u, int mps, int ngs) {
  const int per = mps * ngs, r = u % per;
  return Unit{u / per, r % mps, r / mps};
}
__device__ __forceinline__ int groups(int n) { return (up8(n) / 8 + UNI - 1) / UNI; }

// acc (the unit's m-tiles of the tile's samples x its n-tiles) += the K
// rows from r0 of the activations times a layer's weights, B read as W^T
// (FWD) or W. (Loading the next k-step's weights while one multiplies
// was 2% slower, PERF.md.)
template <bool FWD>
__device__ __forceinline__ void rows_times_weights(
    const float* act, int r0, int K, const Unit& un, const MLayer& y,
    int nt0, int nv, const float* wb, const float* ws,
    float (&acc)[UMI][UNI][4]) {
  RowsA fa[UMI];
  WeightB fb[UNI];
#pragma unroll
  for (int i = 0; i < UMI; ++i) fa[i] = rows_a(r0, 16 * (UMI * un.mp + i));
#pragma unroll
  for (int j = 0; j < UNI; ++j)
    fb[j] = FWD ? weight_b_fwd(y, 8 * (nt0 + j)) : weight_b_dx(y, 8 * (nt0 + j));
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ab[UMI][4], as[UMI][4], bb[UNI][2], bs[UNI][2];
#pragma unroll
    for (int j = 0; j < UNI; ++j)
      if (j < nv)
        load_weight_b<FWD>(wb, ws, fb[j], k0, y.sw, bb[j], bs[j]);
#pragma unroll
    for (int i = 0; i < UMI; ++i) load_rows_a(act, fa[i], k0, ab[i], as[i]);
    mma3_valid(acc, ab, as, bb, bs, UMI, nv);
  }
}

// The forward of layer l over the tile: out rows = tanh(X W^T + b), or X
// W^T + b for the head. All threads; no barrier.
__device__ __forceinline__ void layer_fwd(float* act, const MLayout& lo,
                                          int l, const float* __restrict__ theta,
                                          const float* wb, const float* ws) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool head = l == lo.L;
  const int ngs = groups(lo.ly[0][l].nout);
  for (int u = threadIdx.x >> 5; u < 2 * UMP * ngs; u += UPD_WARPS) {
    const Unit un = unit_of(u, UMP, ngs);
    const MLayer& y = lo.ly[un.t][l];
    const int nt0 = UNI * un.ng, nv = min(UNI, up8(y.nout) / 8 - nt0);
    float acc[UMI][UNI][4];
    zero_frags(acc);
    rows_times_weights<true>(act, y.in_row, up8(y.nin), un, y, nt0, nv, wb,
                             ws, acc);
    const float* bias = theta + y.w + y.nout * y.nin;
#pragma unroll
    for (int j = 0; j < UNI; ++j)
#pragma unroll
      for (int i = 0; i < UMI; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 8 * (nt0 + j) + 2 * t + (r & 1);
          const int m = 16 * (UMI * un.mp + i) + g + (r & 2 ? 8 : 0);
          if (j < nv && n < y.nout) {
            const float v = acc[i][j][r] + __ldg(bias + n);
            act[ai(y.out_row + n, m)] = head ? v : tanhf(v);
          }
        }
  }
}

// The input gradient of layer l >= 1: X rows (its input) = (dY W) * (1 -
// X^2), dY its output rows. All threads; no barrier.
__device__ __forceinline__ void layer_dx(float* act, const MLayout& lo, int l,
                                         const float* wb, const float* ws) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int ngs = groups(lo.ly[0][l].nin);
  for (int u = threadIdx.x >> 5; u < 2 * UMP * ngs; u += UPD_WARPS) {
    const Unit un = unit_of(u, UMP, ngs);
    const MLayer& y = lo.ly[un.t][l];
    const int nt0 = UNI * un.ng, nv = min(UNI, up8(y.nin) / 8 - nt0);
    float acc[UMI][UNI][4];
    zero_frags(acc);
    rows_times_weights<false>(act, y.out_row, up8(y.nout), un, y, nt0, nv,
                              wb, ws, acc);
#pragma unroll
    for (int j = 0; j < UNI; ++j)
#pragma unroll
      for (int i = 0; i < UMI; ++i)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 8 * (nt0 + j) + 2 * t + (r & 1);
          const int m = 16 * (UMI * un.mp + i) + g + (r & 2 ? 8 : 0);
          if (j < nv && n < y.nin) {
            float* x = act + ai(y.in_row + n, m);
            *x = acc[i][j][r] * (1.0f - *x * *x);
          }
        }
  }
}

// The weight and bias gradients of layer l over the tile's window of 64
// samples, folded into the running sums: dW (nout, nin) = dY^T X, db = dY^T
// 1 (the n-group 0 units, a product with a B of ones: big 1, small 0).
// All threads; no barrier.
__device__ __forceinline__ void layer_dw(const float* act, const MLayout& lo,
                                         int l, float* sums) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mps = (up16(lo.ly[0][l].nout) / 16 + UMI - 1) / UMI;
  const int ngs = groups(lo.ly[0][l].nin);
  const uint32_t ones[2] = {0x3f800000u, 0x3f800000u};
  for (int u = threadIdx.x >> 5; u < 2 * mps * ngs; u += UPD_WARPS) {
    const Unit un = unit_of(u, mps, ngs);
    const MLayer& y = lo.ly[un.t][l];
    const int nt0 = UNI * un.ng, nv = min(UNI, up8(y.nin) / 8 - nt0);
    const int mt0 = UMI * un.mp, mv = min(UMI, up16(y.nout) / 16 - mt0);
    const bool bias = un.ng == 0;
    SamplesA fa[UMI], fb[UNI];
#pragma unroll
    for (int i = 0; i < UMI; ++i) fa[i] = samples_a(y.out_row + 16 * (mt0 + i));
#pragma unroll
    for (int j = 0; j < UNI; ++j) fb[j] = samples_a(y.in_row + 8 * (nt0 + j));
    float acc[UMI][UNI][4], accb[UMI][4];
    zero_frags(acc);
#pragma unroll
    for (int i = 0; i < UMI; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) accb[i][r] = 0.0f;
#pragma unroll 2
    for (int s0 = 0; s0 < TILE; s0 += 8) {
      uint32_t ab[UMI][4], as[UMI][4], bb[UNI][2], bs[UNI][2];
#pragma unroll
      for (int i = 0; i < UMI; ++i)
        if (i < mv) load_samples_a(act, fa[i], s0, ab[i], as[i]);
#pragma unroll
      for (int j = 0; j < UNI; ++j)
        if (j < nv) load_samples_b(act, fb[j], s0, bb[j], bs[j]);
      mma3_valid(acc, ab, as, bb, bs, mv, nv);
      if (bias) {
#pragma unroll
        for (int i = 0; i < UMI; ++i)
          if (i < mv) {
            mma_tf32(accb[i], as[i], ones);
            mma_tf32(accb[i], ab[i], ones);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < UMI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 16 * (mt0 + i) + g + 8 * h;
        if (i >= mv || o >= y.nout) continue;
        float* row = sums + y.sb + o * y.ss;
#pragma unroll
        for (int j = 0; j < UNI; ++j) {
          const int c = 8 * (nt0 + j) + 2 * t;
          if (j >= nv) continue;
          const float a0 = acc[i][j][2 * h], a1 = acc[i][j][2 * h + 1];
          if (c + 1 < y.nin) {
            float2* p = reinterpret_cast<float2*>(row + c);
            const float2 s = *p;
            *p = make_float2(s.x + a0, s.y + a1);
          } else if (c < y.nin) {
            row[c] = row[c] + a0;
          }
        }
        if (bias && t == 0) row[y.nin] = row[y.nin] + accb[i][2 * h];
      }
  }
}

struct UArgs {
  const float* planes;   // (T, 21, n)
  const float* advret;   // (2, T, n)
  const int* perm;       // (n_sel,) row-block indices
  const float* theta;    // flat parameters
  const float* wplanes;  // the weight planes (2 wf), the bf16 fragments (4 wq)
  float* scratch;        // (G, sf) running sums, when not on chip
  float* partial;        // (G, P + 8)
  int n, T, rbl, n_tiles, P, ls_off;
};

// K3's fp32 arm (3xTF32); update_kernel<ONCHIP, true> below, on a BLayout,
// is its bf16 arm.
template <bool ONCHIP, bool BF16>
__global__ void __launch_bounds__(UPD_THREADS, 1)
update_kernel(UArgs A, MLayout lo, UConsts co) {
  static_assert(!BF16, "the bf16 arm takes a BLayout");
  extern __shared__ float4 smem4[];
  __shared__ float stat_part[HEAD_WARPS][N_UPSTATS];
  float* act = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const float* wb;
  const float* ws;
  float* sums;
  if constexpr (ONCHIP) {
    float* wsm = act + lo.rows * TILE;
    const float4* src = reinterpret_cast<const float4*>(A.wplanes);
    float4* dst = reinterpret_cast<float4*>(wsm);
    for (int i = tid; i < lo.wf / 2; i += UPD_THREADS)  // both planes
      dst[i] = __ldg(src + i);
    wb = wsm;
    ws = wsm + lo.wf;
    sums = wsm + 2 * lo.wf;
  } else {
    wb = A.wplanes;
    ws = A.wplanes + lo.wf;
    sums = A.scratch + (size_t)blockIdx.x * lo.sf;
  }
  for (int i = tid; i < lo.sf; i += UPD_THREADS) sums[i] = 0.0f;
  // every row a product may read as padding holds a finite value
  for (int i = tid; i < lo.rows * TILE; i += UPD_THREADS) act[i] = 0.0f;
  // the head: sample hs, action dimension hk
  const int hs = tid >> 2, hk = tid & 3;
  const float lsk = A.theta[A.ls_off + hk], stdk = expf(lsk);
  const int nc = A.rbl / TILE;
  float st_acc = 0.0f;
  __syncthreads();
  for (int tau = blockIdx.x; tau < A.n_tiles; tau += gridDim.x) {
    const int tt = tau % A.T;
    const int rest = tau / A.T;
    const int lane0 = A.perm[rest / nc] * A.rbl + (rest % nc) * TILE;
    const float* pl = A.planes + (size_t)tt * N_TRAJ * A.n + lane0;
    for (int e = tid; e < OBS_DIM * TILE; e += UPD_THREADS)
      act[ai(e / TILE, e % TILE)] = pl[(size_t)(TP_OBS0 + e / TILE) * A.n + e % TILE];
    const bool head_thread = tid < HEAD_THREADS;
    const float a_k = head_thread ? pl[(size_t)(TP_ACT0 + hk) * A.n + hs] : 0.0f;
    const float logp_old = head_thread ? pl[(size_t)TP_LOGP * A.n + hs] : 0.0f;
    const float v_old = head_thread ? pl[(size_t)TP_VAL * A.n + hs] : 0.0f;
    const float adv = head_thread ? A.advret[(size_t)tt * A.n + lane0 + hs] : 0.0f;
    const float ret =
        head_thread ? A.advret[((size_t)A.T + tt) * A.n + lane0 + hs] : 0.0f;
    __syncthreads();
    for (int l = 0; l <= lo.L; ++l) {
      layer_fwd(act, lo, l, A.theta, wb, ws);
      __syncthreads();
    }

    // _head_grads: four threads a sample, the log-prob's terms summed in
    // the reference's order; the stats summed over the warp's 8 samples
    if (head_thread) {
      const float m = act[ai(lo.hm + hk, hs)];
      const float v = act[ai(lo.hv, hs)];
      const float z = (a_k - m) / stdk;
      const float term = -0.5f * (z * z) - lsk - HALF_LOG_2PI;
      const int q = lane & ~3;
      const float lp = ((__shfl_sync(0xffffffffu, term, q) +
                         __shfl_sync(0xffffffffu, term, q + 1)) +
                        __shfl_sync(0xffffffffu, term, q + 2)) +
                       __shfl_sync(0xffffffffu, term, q + 3);
      const float ratio = expf(lp - logp_old);
      const float pg1 = -adv * ratio;
      const float rclip = fminf(fmaxf(ratio, co.clip_lo), co.clip_hi);
      const float pg2 = -adv * rclip;
      const float pg = fmaxf(pg1, pg2);
      const bool use1 = pg1 >= pg2;
      const bool inclip = (ratio >= co.clip_lo) & (ratio <= co.clip_hi);
      const float dpg = (use1 | inclip) ? -adv : 0.0f;
      const float g_logp = co.inv_m * dpg * ratio;
      const float dv_raw = v - ret;
      const float vdiff = fminf(fmaxf(v - v_old, -co.vf_clip), co.vf_clip);
      const float dv_c = (v_old + vdiff) - ret;
      const float vl = fmaxf(dv_raw * dv_raw, dv_c * dv_c);
      const bool use_raw = (dv_raw * dv_raw) >= (dv_c * dv_c);
      const bool in_vclip = (v - v_old >= -co.vf_clip) & (v - v_old <= co.vf_clip);
      const float dvl = use_raw ? 2.0f * dv_raw : (in_vclip ? 2.0f * dv_c : 0.0f);
      __syncwarp();  // every thread of the sample has read v
      act[ai(lo.hm + hk, hs)] = g_logp * (z / expf(lsk));
      if (hk == 0) act[ai(lo.hv, hs)] = co.half_vf_coef * co.inv_m * dvl;
      float sv[5] = {pg, vl, logp_old - lp,
                     fabsf(ratio - 1.0f) > co.clip_eps ? 1.0f : 0.0f,
                     g_logp * (z * z - 1.0f)};
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int k = 0; k < 5; ++k)
          sv[k] = sv[k] + __shfl_xor_sync(0xffffffffu, sv[k], o);
      if (lane == 0)
#pragma unroll
        for (int k = 0; k < 4; ++k) stat_part[w][k] = sv[k];
      if (lane < 4) stat_part[w][4 + lane] = sv[4];
    }
    __syncthreads();
    if (tid < N_UPSTATS) {
      float tile_sum = stat_part[0][tid];
      for (int k = 1; k < HEAD_WARPS; ++k) tile_sum = tile_sum + stat_part[k][tid];
      st_acc = st_acc + tile_sum;
    }
    for (int l = lo.L; l >= 0; --l) {
      layer_dw(act, lo, l, sums);
      __syncthreads();
      if (l == 0) break;
      layer_dx(act, lo, l, wb, ws);
      __syncthreads();
    }
  }
  // the block's partial row, in the flat buffer's order
  float* part = A.partial + (size_t)blockIdx.x * (A.P + N_UPSTATS);
  for (int e = tid; e < A.P; e += UPD_THREADS) {
    if (e >= A.ls_off && e < A.ls_off + 4) continue;
    for (int t = 0; t < 2; ++t)
      for (int l = 0; l <= lo.L; ++l) {
        const MLayer& y = lo.ly[t][l];
        const int r = e - y.w;
        if (r < 0 || r >= y.nout * (y.nin + 1)) continue;
        part[e] = r < y.nout * y.nin
                      ? sums[y.sb + (r / y.nin) * y.ss + r % y.nin]
                      : sums[y.sb + (r - y.nout * y.nin) * y.ss + y.nin];
      }
  }
  if (tid < N_UPSTATS) {
    part[A.P + tid] = st_acc;
    if (tid >= 4) part[A.ls_off + tid - 4] = st_acc;
  }
}

// The big and the small TF32 planes of the towers' weights (MLayout's wp,
// sw, swzl): element e of a layer's plane is W[o][i] (o = e / sw, i = the
// column e % sw unswizzled), 0 past nout or nin.
__global__ void pack_planes_kernel(const float* __restrict__ theta,
                                   MLayout lo, float* __restrict__ planes) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= lo.wf) return;
  float v = 0.0f;
  for (int t = 0; t < 2; ++t)
    for (int l = 0; l <= lo.L; ++l) {
      const MLayer& y = lo.ly[t][l];
      const int p = e - y.wp;
      if (p < 0 || p >= up8(y.nout) * y.sw) continue;
      const int o = p / y.sw, c = p % y.sw;
      const int i = y.swzl ? c ^ swz(o) : c;
      if (o < y.nout && i < y.nin) v = theta[y.w + o * y.nin + i];
    }
  uint32_t b, s;
  split_tf32(v, b, s);
  planes[e] = __uint_as_float(b);
  planes[lo.wf + e] = __uint_as_float(s);
}

// ---------------------------------------------------------------------------
// K3's bf16 arm: every product on the bf16 tensor cores (m16n8k16)
// ---------------------------------------------------------------------------
//
// The products run with the units along M and the tile's samples along N:
// the forward Y^T = W X^T, the input gradient dX^T = W^T dY^T, and the
// weight gradient dW = dY^T X (K = the tile's 64 samples). Their operands
// are stored once as bf16, by the store that writes them:
//   - the activation rows, [unit][sample] at B16_S (72) bf16 a row (144
//     bytes, so ldmatrix's eight 16-byte rows fall in distinct banks): the
//     obs by the tile's conversion, each tanh output by the forward's
//     epilogue, each dY by the head and by the input gradient's epilogue
//     (over the layer's outputs, which the weight gradient has read). A
//     layer's rows are padded to 16 with zero rows (the products' K and M);
//   - the weights as A fragments, packed once a call (pack_b16_kernel): W's
//     for the forward, W^T's for the input gradient, a uint4 a lane a 16 x
//     16 tile (bf16x2 pairs), one 16-byte load a k-step.
// B fragments come by ldmatrix (.trans from the k-major rows of the forward
// and the input gradient), the weight gradient's A by ldmatrix too. What
// stays fp32: each tanh output beside its bf16 copy (the derivative 1 - y^2
// reads it), the heads' outputs, the head, and db, the fp32 sum of dY over
// the tile (the head's warp butterflies; the input gradient's epilogue,
// whose units span the tile's 64 samples), folded into the running sums by
// one thread each. dW sums each window of 64 samples from zero and folds it
// into the running sums with IEEE adds (H10), each entry always by the same
// thread (H6). On chip (ONCHIP) the fp32 tanh rows, the fragments and the
// running sums sit in shared memory beside the bf16 rows; else in device
// memory (the fragments buffer and a block's scratch row), read through L1.
// (The next tile's planes copied by cp.async during the current one, the
// input gradient's units over half the tile's samples, and the heads'
// units of 2 n-tiles each timed no faster: PERF.md.)

constexpr int B16_S = TILE + 8;        // a bf16 activation row (144 bytes)
constexpr int B16_MAX_BLOCKS = 132;    // one block an SM of an H100
constexpr int FNI = 4;  // n-tiles (8 samples) of a forward unit
constexpr int WNI = 4;  // n-tiles (8 inputs) of a weight-gradient unit
// the head's warp sums: the stats, then db of the 4 means and the value
constexpr int B16_HEAD_STATS = N_UPSTATS + 5;

// One layer of one tower.
struct BLayer {
  int nin, nout;
  int w;                // offset of W (nout, nin) in theta; its bias follows
  int fa, ta;           // its A fragments (uint4s): W's, W^T's (l >= 1)
  int sb, ss;           // its running sums: offset, row stride
  int in_row, out_row;  // the bf16 rows of its input and of its output (dY)
  int y32;              // its output's fp32 rows (the head's: 0 means, 4 value)
};

struct BLayout {
  int L;      // hidden layers
  int wq;     // uint4s of the fragments
  int sf;     // floats of the running sums
  int rows;   // bf16 rows: the obs, the towers' hidden layers, the heads' dY
              // (16 each)
  int yrows;  // fp32 rows of the hidden layers' tanh outputs
  BLayer ly[2][UPD_HIDDEN + 1];  // actor, critic; layer L is the head
};

// the static shared memory of update_kernel<ONCHIP, true>
constexpr size_t B16_STATIC_BYTES =
    sizeof(BLayout) + sizeof(float) * HEAD_WARPS * B16_HEAD_STATS;

// The bf16 layout of towers `width[0..L)` (ops/cuda_update.py b16_layout
// mirrors it).
inline void make_layout_b16(int L, const int* width, const int* wa,
                            const int* wc, BLayout& lo) {
  int h16 = 0, h = 0;
  for (int l = 0; l < L; ++l) {
    h16 += up16(width[l]);
    h += width[l];
  }
  lo.L = L;
  lo.rows = 16 + 2 * h16 + 2 * 16;
  lo.yrows = 2 * h;
  int q = 0, sb = 0;
  for (int t = 0; t < 2; ++t) {
    int row = 16 + t * h16, yrow = t * h, nin = OBS_DIM, in_row = 0;
    for (int l = 0; l <= L; ++l) {
      BLayer& y = lo.ly[t][l];
      y.nin = nin;
      y.nout = l < L ? width[l] : (t == 0 ? 4 : 1);
      y.w = (t == 0 ? wa : wc)[l];
      y.fa = q;
      q += up16(y.nout) / 16 * (up16(nin) / 16) * 32;
      y.ta = q;
      if (l > 0) q += up16(nin) / 16 * (up16(y.nout) / 16) * 32;
      y.ss = sums_stride(nin);
      y.sb = sb;
      sb += y.nout * y.ss;
      y.in_row = in_row;
      y.out_row = l < L ? row : 16 + 2 * h16 + 16 * t;
      y.y32 = l < L ? yrow : 4 * t;
      if (l < L) {
        row += up16(y.nout);
        yrow += y.nout;
      }
      in_row = y.out_row;
      nin = y.nout;
    }
  }
  lo.wq = q;
  lo.sf = sb;
}

// Dynamic shared memory of a block: the bf16 rows, the heads' fp32 rows,
// then on chip the fp32 tanh rows, the fragments and the running sums.
inline size_t layout_smem_b16(const BLayout& lo, bool onchip) {
  return 2 * (size_t)lo.rows * B16_S + 4 * (size_t)8 * TILE +
         (onchip ? 4 * (size_t)lo.yrows * TILE + 16 * (size_t)lo.wq +
                       4 * (size_t)lo.sf
                 : 0);
}

// fp32 row r, sample s: a fragment's float2 stores and reads are free of
// bank conflicts
__device__ __forceinline__ int yi(int r, int s) {
  return r * TILE + (s ^ ((r & 3) << 3));
}

// B fragments of the n-tiles at n0 and n0 + 8 over the k-rows k0 .. k0 + 15
// of bf16 rows X (k-major: row k, n along it): ldmatrix.trans
__device__ __forceinline__ void ldb_k(const uint16_t* X, int k0, int n0,
                                      uint32_t (&b0)[2], uint32_t (&b1)[2]) {
  const int lane = threadIdx.x & 31, r = lane & 7, q = lane >> 3;
  uint32_t v[4];
  ldsm_x4_t(v, X + (k0 + r + 8 * (q & 1)) * B16_S + n0 + 8 * (q >> 1));
  b0[0] = v[0];
  b0[1] = v[1];
  b1[0] = v[2];
  b1[1] = v[3];
}

// The A fragment of rows m0 .. m0 + 15 over k0 .. k0 + 15 of bf16 rows X
// (row m, k along it): ldmatrix
__device__ __forceinline__ void lda_m(const uint16_t* X, int m0, int k0,
                                      uint32_t (&a)[4]) {
  const int lane = threadIdx.x & 31, r = lane & 7, q = lane >> 3;
  ldsm_x4(a, X + (m0 + r + 8 * (q & 1)) * B16_S + k0 + 8 * (q >> 1));
}

// B fragments of the n-tiles of rows n0 and n0 + 8 over k0 .. k0 + 15 of
// bf16 rows X (row n, k along it): ldmatrix
__device__ __forceinline__ void ldb_n(const uint16_t* X, int n0, int k0,
                                      uint32_t (&b0)[2], uint32_t (&b1)[2]) {
  const int lane = threadIdx.x & 31, r = lane & 7, q = lane >> 3;
  uint32_t v[4];
  ldsm_x4(v, X + (n0 + r + 8 * (q >> 1)) * B16_S + k0 + 8 * (q & 1));
  b0[0] = v[0];
  b0[1] = v[1];
  b1[0] = v[2];
  b1[1] = v[3];
}

// The forward of layer l over the tile: out = tanh(W X + b) (its fp32 and
// bf16 rows), or the head's W X + b (fp32). A unit: 16 outputs x FNI
// n-tiles of samples, both towers' units side by side. All threads; no
// barrier.
__device__ __forceinline__ void fwd_b16(const BLayout& lo, int l,
                                        uint16_t* xb, float* yh, float* hf,
                                        const uint4* wf,
                                        const float* __restrict__ theta) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool head = l == lo.L;
  const int mts = up16(lo.ly[0][l].nout) / 16, per = mts * (TILE / 8 / FNI);
  for (int u = threadIdx.x >> 5; u < 2 * per; u += UPD_WARPS) {
    const int tw = u / per, mt = u % per % mts, n0 = 8 * FNI * (u % per / mts);
    const BLayer& y = lo.ly[tw][l];
    const int kts = up16(y.nin) / 16;
    const uint4* ap = wf + y.fa + mt * kts * 32 + lane;
    const uint16_t* xp = xb + y.in_row * B16_S;
    float acc[FNI][4];
#pragma unroll
    for (int j = 0; j < FNI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
#pragma unroll 2
    for (int kt = 0; kt < kts; ++kt) {
      const uint4 w4 = ap[32 * kt];
      const uint32_t a[4] = {w4.x, w4.y, w4.z, w4.w};
      uint32_t b[FNI][2];
#pragma unroll
      for (int j = 0; j < FNI; j += 2)
        ldb_k(xp, 16 * kt, n0 + 8 * j, b[j], b[j + 1]);
#pragma unroll
      for (int j = 0; j < FNI; ++j) mma_bf16(acc[j], a, b[j]);
    }
    const float* bias = theta + y.w + y.nout * y.nin;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = 16 * mt + g + 8 * h;
      if (o >= y.nout) continue;
      const float bo = __ldg(bias + o);
#pragma unroll
      for (int j = 0; j < FNI; ++j) {
        const int s = n0 + 8 * j + 2 * t;
        float v0 = acc[j][2 * h] + bo, v1 = acc[j][2 * h + 1] + bo;
        if (head) {
          *reinterpret_cast<float2*>(hf + yi(y.y32 + o, s)) =
              make_float2(v0, v1);
        } else {
          v0 = tanhf(v0);
          v1 = tanhf(v1);
          *reinterpret_cast<float2*>(yh + yi(y.y32 + o, s)) =
              make_float2(v0, v1);
          *reinterpret_cast<uint32_t*>(xb + (y.out_row + o) * B16_S + s) =
              bf16x2(v0, v1);
        }
      }
    }
  }
}

// The input gradient of layer l >= 1: dY of layer l - 1 = (W^T dY) * (1 -
// y^2) over the tile, its bf16 over the layer's bf16 outputs and its fp32
// sum over the tile's samples folded into db. A unit: 16 inputs x the
// tile's 64 samples. All threads; no barrier.
__device__ __forceinline__ void dx_b16(const BLayout& lo, int l, uint16_t* xb,
                                       const float* yh, const uint4* wf,
                                       float* sums) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  constexpr int NI = TILE / 8;
  const int mts = up16(lo.ly[0][l].nin) / 16;
  for (int u = threadIdx.x >> 5; u < 2 * mts; u += UPD_WARPS) {
    const int tw = u / mts, mt = u % mts;
    const BLayer& y = lo.ly[tw][l];
    const BLayer& p = lo.ly[tw][l - 1];
    const int kts = up16(y.nout) / 16;
    const uint4* ap = wf + y.ta + mt * kts * 32 + lane;
    const uint16_t* dp = xb + y.out_row * B16_S;
    float acc[NI][4];
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
#pragma unroll 2
    for (int kt = 0; kt < kts; ++kt) {
      const uint4 w4 = ap[32 * kt];
      const uint32_t a[4] = {w4.x, w4.y, w4.z, w4.w};
      uint32_t b[NI][2];
#pragma unroll
      for (int j = 0; j < NI; j += 2) ldb_k(dp, 16 * kt, 8 * j, b[j], b[j + 1]);
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_bf16(acc[j], a, b[j]);
    }
    float db[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * mt + g + 8 * h;
      if (i >= y.nin) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int s = 8 * j + 2 * t;
        const float2 yv =
            *reinterpret_cast<const float2*>(yh + yi(p.y32 + i, s));
        const float d0 = acc[j][2 * h] * (1.0f - yv.x * yv.x);
        const float d1 = acc[j][2 * h + 1] * (1.0f - yv.y * yv.y);
        *reinterpret_cast<uint32_t*>(xb + (p.out_row + i) * B16_S + s) =
            bf16x2(d0, d1);
        db[h] = (db[h] + d0) + d1;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      db[h] = db[h] + __shfl_xor_sync(0xffffffffu, db[h], 1);
      db[h] = db[h] + __shfl_xor_sync(0xffffffffu, db[h], 2);
      const int i = 16 * mt + g + 8 * h;
      if (t == 0 && i < y.nin) {
        float* e = sums + p.sb + i * p.ss + p.nin;
        *e = *e + db[h];
      }
    }
  }
}

// The weight gradient of layer l over the tile's window of 64 samples,
// folded into the running sums: dW (nout, nin) = dY^T X. A unit: 16
// outputs x WNI n-tiles of inputs. All threads; no barrier.
__device__ __forceinline__ void dw_b16(const BLayout& lo, int l,
                                       const uint16_t* xb, float* sums) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int mts = up16(lo.ly[0][l].nout) / 16, nts = up8(lo.ly[0][l].nin) / 8;
  const int per = mts * ((nts + WNI - 1) / WNI);
  for (int u = threadIdx.x >> 5; u < 2 * per; u += UPD_WARPS) {
    const int tw = u / per, mt = u % per % mts, nt0 = WNI * (u % per / mts);
    const BLayer& y = lo.ly[tw][l];
    const int nv = min(WNI, nts - nt0);
    const uint16_t* ap = xb + y.out_row * B16_S;
    const uint16_t* bp = xb + y.in_row * B16_S;
    float acc[WNI][4];
#pragma unroll
    for (int j = 0; j < WNI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.0f;
#pragma unroll
    for (int s0 = 0; s0 < TILE; s0 += 16) {
      uint32_t a[4], b[WNI][2];
      lda_m(ap, 16 * mt, s0, a);
#pragma unroll
      for (int j = 0; j < WNI; j += 2)
        if (j < nv) ldb_n(bp, 8 * (nt0 + j), s0, b[j], b[j + 1]);
#pragma unroll
      for (int j = 0; j < WNI; ++j)
        if (j < nv) mma_bf16(acc[j], a, b[j]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = 16 * mt + g + 8 * h;
      if (o >= y.nout) continue;
      float* row = sums + y.sb + o * y.ss;
#pragma unroll
      for (int j = 0; j < WNI; ++j) {
        const int c = 8 * (nt0 + j) + 2 * t;
        if (j >= nv) continue;
        const float a0 = acc[j][2 * h], a1 = acc[j][2 * h + 1];
        if (c + 1 < y.nin) {
          float2* p = reinterpret_cast<float2*>(row + c);
          const float2 s = *p;
          *p = make_float2(s.x + a0, s.y + a1);
        } else if (c < y.nin) {
          row[c] = row[c] + a0;
        }
      }
    }
  }
}

// K3's bf16 arm (compute_dtype="bfloat16"; the fp32 arm above takes an
// MLayout). Per tile: the forward, layer by layer; the head (_head_grads,
// four threads a sample, as the fp32 arm's) writing dY's bf16 rows of the
// heads and their db's warp sums; then from the head down each layer's
// weight gradient and input gradient, a barrier after each phase (10 a
// tile at two hidden layers).
template <bool ONCHIP, bool BF16>
__global__ void __launch_bounds__(UPD_THREADS, 1)
update_kernel(UArgs A, BLayout blo, UConsts co) {
  static_assert(BF16, "the fp32 arm takes an MLayout");
  extern __shared__ float4 smem4[];
  __shared__ float stat_part[HEAD_WARPS][B16_HEAD_STATS];
  __shared__ BLayout lo;  // indexed by tower and layer at run time
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  for (int i = tid; i < (int)(sizeof(BLayout) / sizeof(int)); i += UPD_THREADS)
    reinterpret_cast<int*>(&lo)[i] = reinterpret_cast<const int*>(&blo)[i];
  uint16_t* xb = reinterpret_cast<uint16_t*>(smem4);
  float* hf = reinterpret_cast<float*>(xb + blo.rows * B16_S);  // 8 rows
  float* yh;
  const uint4* wf;
  float* sums;
  if constexpr (ONCHIP) {
    yh = hf + 8 * TILE;
    uint4* wsm = reinterpret_cast<uint4*>(yh + blo.yrows * TILE);
    const uint4* src = reinterpret_cast<const uint4*>(A.wplanes);
    for (int i = tid; i < blo.wq; i += UPD_THREADS) wsm[i] = __ldg(src + i);
    wf = wsm;
    sums = reinterpret_cast<float*>(wsm + blo.wq);
  } else {
    sums = A.scratch + (size_t)blockIdx.x * (blo.sf + blo.yrows * TILE);
    yh = sums + blo.sf;
    wf = reinterpret_cast<const uint4*>(A.wplanes);
  }
  for (int i = tid; i < blo.sf; i += UPD_THREADS) sums[i] = 0.0f;
  // the padding rows every product reads stay zero
  for (int i = tid; i < blo.rows * B16_S / 2; i += UPD_THREADS)
    reinterpret_cast<uint32_t*>(xb)[i] = 0u;
  // the head: sample hs, action dimension hk
  const int hs = tid >> 2, hk = tid & 3;
  const bool head_thread = tid < HEAD_THREADS;
  const float lsk = A.theta[A.ls_off + hk], stdk = expf(lsk);
  float st_acc = 0.0f;
  const int nc = A.rbl / TILE;
  __syncthreads();  // the layout, the zeroed rows and sums
  for (int tau = blockIdx.x; tau < A.n_tiles; tau += gridDim.x) {
    const int tt = tau % A.T;
    const int rest = tau / A.T;
    const int lane0 = A.perm[rest / nc] * A.rbl + (rest % nc) * TILE;
    const float* pl = A.planes + (size_t)tt * N_TRAJ * A.n + lane0;
    if (tid < OBS_DIM * TILE / 2) {  // the obs, rounded by pairs of samples
      const int r = tid / (TILE / 2), s = 2 * (tid % (TILE / 2));
      const float2 v = *reinterpret_cast<const float2*>(
          pl + (size_t)(TP_OBS0 + r) * A.n + s);
      *reinterpret_cast<uint32_t*>(xb + r * B16_S + s) = bf16x2(v.x, v.y);
    }
    float a_k = 0.0f, logp_old = 0.0f, v_old = 0.0f, adv = 0.0f, ret = 0.0f;
    if (head_thread) {
      a_k = pl[(size_t)(TP_ACT0 + hk) * A.n + hs];
      logp_old = pl[(size_t)TP_LOGP * A.n + hs];
      v_old = pl[(size_t)TP_VAL * A.n + hs];
      adv = A.advret[(size_t)tt * A.n + lane0 + hs];
      ret = A.advret[((size_t)A.T + tt) * A.n + lane0 + hs];
    }
    __syncthreads();  // the tile's obs rows
    for (int l = 0; l <= lo.L; ++l) {
      fwd_b16(lo, l, xb, yh, hf, wf, A.theta);
      __syncthreads();
    }

    // _head_grads: four threads a sample, the log-prob's terms summed in
    // the reference's order; the stats and db summed over the warp's 8
    // samples
    if (head_thread) {
      const float m = hf[yi(hk, hs)];
      const float v = hf[yi(4, hs)];
      const float z = (a_k - m) / stdk;
      const float term = -0.5f * (z * z) - lsk - HALF_LOG_2PI;
      const int q = lane & ~3;
      const float lp = ((__shfl_sync(0xffffffffu, term, q) +
                         __shfl_sync(0xffffffffu, term, q + 1)) +
                        __shfl_sync(0xffffffffu, term, q + 2)) +
                       __shfl_sync(0xffffffffu, term, q + 3);
      const float ratio = expf(lp - logp_old);
      const float pg1 = -adv * ratio;
      const float rclip = fminf(fmaxf(ratio, co.clip_lo), co.clip_hi);
      const float pg2 = -adv * rclip;
      const float pg = fmaxf(pg1, pg2);
      const bool use1 = pg1 >= pg2;
      const bool inclip = (ratio >= co.clip_lo) & (ratio <= co.clip_hi);
      const float dpg = (use1 | inclip) ? -adv : 0.0f;
      const float g_logp = co.inv_m * dpg * ratio;
      const float dv_raw = v - ret;
      const float vdiff = fminf(fmaxf(v - v_old, -co.vf_clip), co.vf_clip);
      const float dv_c = (v_old + vdiff) - ret;
      const float vl = fmaxf(dv_raw * dv_raw, dv_c * dv_c);
      const bool use_raw = (dv_raw * dv_raw) >= (dv_c * dv_c);
      const bool in_vclip =
          (v - v_old >= -co.vf_clip) & (v - v_old <= co.vf_clip);
      const float dvl =
          use_raw ? 2.0f * dv_raw : (in_vclip ? 2.0f * dv_c : 0.0f);
      const float dm = g_logp * (z / expf(lsk));
      const float dv = co.half_vf_coef * co.inv_m * dvl;
      xb[(lo.ly[0][lo.L].out_row + hk) * B16_S + hs] = bf16_bits(dm);
      if (hk == 0) xb[lo.ly[1][lo.L].out_row * B16_S + hs] = bf16_bits(dv);
      float sv[7] = {pg, vl, logp_old - lp,
                     fabsf(ratio - 1.0f) > co.clip_eps ? 1.0f : 0.0f,
                     g_logp * (z * z - 1.0f), dm, hk == 0 ? dv : 0.0f};
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int k = 0; k < 7; ++k)
          sv[k] = sv[k] + __shfl_xor_sync(0xffffffffu, sv[k], o);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) stat_part[w][k] = sv[k];
        stat_part[w][N_UPSTATS + 4] = sv[6];
      }
      if (lane < 4) {
        stat_part[w][4 + lane] = sv[4];
        stat_part[w][N_UPSTATS + lane] = sv[5];
      }
    }
    __syncthreads();
    if (tid < B16_HEAD_STATS) {
      float tile_sum = stat_part[0][tid];
      for (int k = 1; k < HEAD_WARPS; ++k)
        tile_sum = tile_sum + stat_part[k][tid];
      if (tid < N_UPSTATS) {
        st_acc = st_acc + tile_sum;
      } else {  // the heads' db: the 4 means', the value's
        const int k = tid - N_UPSTATS;
        const BLayer& y = lo.ly[k == 4][lo.L];
        float* e = sums + y.sb + (k == 4 ? 0 : k) * y.ss + y.nin;
        *e = *e + tile_sum;
      }
    }
    for (int l = lo.L; l >= 0; --l) {
      dw_b16(lo, l, xb, sums);
      __syncthreads();
      if (l == 0) break;
      dx_b16(lo, l, xb, yh, wf, sums);
      __syncthreads();
    }
  }
  // the block's partial row, in the flat buffer's order
  float* part = A.partial + (size_t)blockIdx.x * (A.P + N_UPSTATS);
  for (int e = tid; e < A.P; e += UPD_THREADS) {
    if (e >= A.ls_off && e < A.ls_off + 4) continue;
    for (int t = 0; t < 2; ++t)
      for (int l = 0; l <= lo.L; ++l) {
        const BLayer& y = lo.ly[t][l];
        const int r = e - y.w;
        if (r < 0 || r >= y.nout * (y.nin + 1)) continue;
        part[e] = r < y.nout * y.nin
                      ? sums[y.sb + (r / y.nin) * y.ss + r % y.nin]
                      : sums[y.sb + (r - y.nout * y.nin) * y.ss + y.nin];
      }
  }
  if (tid < N_UPSTATS) {
    part[A.P + tid] = st_acc;
    if (tid >= 4) part[A.ls_off + tid - 4] = st_acc;
  }
}

// The bf16 arm's A fragments (BLayout's fa, ta): uint4 e is lane e % 32 of
// a 16 x 16 tile of A = W (the forward; M its outputs) or W^T (the input
// gradient), the bf16x2 pairs (A[m][k], A[m][k + 1]) at (m, k) = (g, 2t),
// (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8) of the tile (m16n8k16's a0..a3),
// 0 past the layer's widths; a layer's tiles row-major.
__global__ void pack_b16_kernel(const float* __restrict__ theta, BLayout lo,
                                uint4* __restrict__ frags) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= lo.wq) return;
  const int tile = e >> 5, lane = e & 31, g = lane >> 2, t = lane & 3;
  for (int tw = 0; tw < 2; ++tw)
    for (int l = 0; l <= lo.L; ++l)
      for (int tr = 0; tr < (l > 0 ? 2 : 1); ++tr) {
        const BLayer& y = lo.ly[tw][l];
        const int M = tr ? y.nin : y.nout, K = tr ? y.nout : y.nin;
        const int kts = up16(K) / 16, q = tile - (tr ? y.ta : y.fa) / 32;
        if (q < 0 || q >= up16(M) / 16 * kts) continue;
        const float* W = theta + y.w;
        auto a = [&](int m, int k) {
          return m < M && k < K ? W[tr ? k * y.nin + m : m * y.nin + k] : 0.0f;
        };
        const int m = 16 * (q / kts) + g, k = 16 * (q % kts) + 2 * t;
        frags[e] = make_uint4(bf16x2(a(m, k), a(m, k + 1)),
                              bf16x2(a(m + 8, k), a(m + 8, k + 1)),
                              bf16x2(a(m, k + 8), a(m, k + 9)),
                              bf16x2(a(m + 8, k + 8), a(m + 8, k + 9)));
      }
}

// Sum the G partial rows in block order: the gradients (log_std's minus
// ent_coef, the entropy term) and the 8 stat sums.
__global__ void reduce_kernel(const float* __restrict__ partial, int G, int P,
                              int ls_off, float ent_coef,
                              float* __restrict__ grads,
                              float* __restrict__ stats) {
  const int PW = P + N_UPSTATS;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PW) return;
  float s = 0.0f;
  for (int b = 0; b < G; ++b) s = s + partial[(size_t)b * PW + e];
  if (e >= P)
    stats[e - P] = s;
  else
    grads[e] = (e >= ls_off && e < ls_off + 4) ? s - ent_coef : s;
}

// ---------------------------------------------------------------------------
// K4: clip_by_global_norm + adam
// ---------------------------------------------------------------------------

constexpr int ADAM_THREADS = 256;
constexpr int ADAM_SLICE = 8 * ADAM_THREADS;  // floats a block, 8 a thread
// the most blocks of a launch: 2 an SM of an H100 are co-resident; a larger
// buffer gives each block several slices
constexpr int ADAM_MAX_BLOCKS = 256;
// the largest buffer: slice offsets stay within int
constexpr int ADAM_MAX_P = 1 << 30;

struct AdamC {
  float lr, total_steps, b1, b2, eps, clip, log_b1, log_b2;
  int anneal;
};

// The sum over a warp, the same in each lane (a butterfly in a fixed order).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int w = 16; w > 0; w /= 2) v = v + __shfl_xor_sync(0xffffffffu, v, w);
  return v;
}

// The four floats at e of the buffers, as float4 when the buffers are
// aligned and all four lie in [0, P), else one at a time (0 past P).
__device__ __forceinline__ void adam_load(
    const float* __restrict__ theta, const float* __restrict__ grads,
    const float* __restrict__ mu, const float* __restrict__ nu, int e, int P,
    bool vec, float* g, float* m, float* v, float* w) {
  if (vec && e + 3 < P) {
    const float4 a = *reinterpret_cast<const float4*>(grads + e);
    const float4 b = *reinterpret_cast<const float4*>(mu + e);
    const float4 c = *reinterpret_cast<const float4*>(nu + e);
    const float4 d = *reinterpret_cast<const float4*>(theta + e);
    g[0] = a.x; g[1] = a.y; g[2] = a.z; g[3] = a.w;
    m[0] = b.x; m[1] = b.y; m[2] = b.z; m[3] = b.w;
    v[0] = c.x; v[1] = c.y; v[2] = c.z; v[3] = c.w;
    w[0] = d.x; w[1] = d.y; w[2] = d.z; w[3] = d.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool in = e + k < P;
      g[k] = in ? grads[e + k] : 0.0f;
      m[k] = in ? mu[e + k] : 0.0f;
      v[k] = in ? nu[e + k] : 0.0f;
      w[k] = in ? theta[e + k] : 0.0f;
    }
  }
}

// The squares of a slice's gradient floats the thread owns (8, in order).
__device__ __forceinline__ float adam_squares(const float* __restrict__ grads,
                                              int s, int P, bool vec) {
  float ss = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = s * ADAM_SLICE + 4 * (threadIdx.x + h * ADAM_THREADS);
    float g[4];
    if (vec && e + 3 < P) {
      const float4 a = *reinterpret_cast<const float4*>(grads + e);
      g[0] = a.x; g[1] = a.y; g[2] = a.z; g[3] = a.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) g[k] = e + k < P ? grads[e + k] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) ss = ss + g[k] * g[k];
  }
  return ss;
}

struct AdamStep {
  float scale, lr, bc1, bc2;
};

// The adam update of four floats at e, written back as they were read.
__device__ __forceinline__ void adam_apply(
    float* __restrict__ theta, float* __restrict__ mu, float* __restrict__ nu,
    int e, int P, bool vec, const AdamC& ac, const AdamStep& st,
    const float* g, float* m, float* v, float* w) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float gc = g[k] * st.scale;
    const float mu2 = ac.b1 * m[k] + (1.0f - ac.b1) * gc;
    const float nu2 = ac.b2 * v[k] + (1.0f - ac.b2) * (gc * gc);
    const float upd = -st.lr * (mu2 / st.bc1) / (sqrtf(nu2 / st.bc2) + ac.eps);
    w[k] = w[k] + upd;
    m[k] = mu2;
    v[k] = nu2;
  }
  if (vec && e + 3 < P) {
    *reinterpret_cast<float4*>(theta + e) = make_float4(w[0], w[1], w[2], w[3]);
    *reinterpret_cast<float4*>(mu + e) = make_float4(m[0], m[1], m[2], m[3]);
    *reinterpret_cast<float4*>(nu + e) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e + k < P) {
        theta[e + k] = w[k];
        mu[e + k] = m[k];
        nu[e + k] = v[k];
      }
  }
}

// The buffer is cut into slices of ADAM_SLICE floats; block b of the G =
// min(ceil(P / ADAM_SLICE), ADAM_MAX_BLOCKS) blocks owns the slices b, b +
// G, b + 2 G, ... (one slice each when P <= ADAM_MAX_BLOCKS ADAM_SLICE);
// thread t the floats 4 t + 4 ADAM_THREADS h .. + 3 (h = 0, 1) of each, its
// first slice's held in registers across the barrier. Phase 1: the block's
// sum of squares (each thread's floats in slice order, warp butterflies,
// the warps in order) into part[b]. The grid's barrier. Phase 2: every warp
// of every block adds part[0 .. G) in the same fixed order, so all get the
// same norm bit for bit; then the adam update of the thread's floats, the
// first slice from registers, the later ones read again.
__global__ void __launch_bounds__(ADAM_THREADS)
adam_kernel(float* __restrict__ theta, const float* __restrict__ grads,
            float* __restrict__ mu, float* __restrict__ nu,
            float* __restrict__ count, float* __restrict__ part, int P,
            AdamC ac) {
  __shared__ float wsum[ADAM_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = ((reinterpret_cast<uintptr_t>(theta) |
                     reinterpret_cast<uintptr_t>(grads) |
                     reinterpret_cast<uintptr_t>(mu) |
                     reinterpret_cast<uintptr_t>(nu)) & 15) == 0;
  const int G = (int)gridDim.x;
  int e0[2];
  float g[2][4], m[2][4], v[2][4], w[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    e0[h] = blockIdx.x * ADAM_SLICE + 4 * (threadIdx.x + h * ADAM_THREADS);
    adam_load(theta, grads, mu, nu, e0[h], P, vec, g[h], m[h], v[h], w[h]);
  }
  float ss = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 4; ++k) ss = ss + g[h][k] * g[h][k];
  // the block's later slices (none when P <= ADAM_MAX_BLOCKS ADAM_SLICE)
  for (int s = blockIdx.x + G; s < (P + ADAM_SLICE - 1) / ADAM_SLICE; s += G)
    ss = ss + adam_squares(grads, s, P, vec);
  ss = warp_sum(ss);
  if (lane == 0) wsum[warp] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float bs = 0.0f;
    for (int k = 0; k < ADAM_THREADS / 32; ++k) bs = bs + wsum[k];
    part[blockIdx.x] = bs;
  }
  const float cnt = count[0];  // read by every block before the barrier
  cooperative_groups::this_grid().sync();
  float tot = 0.0f;
  for (int b = lane; b < G; b += 32) tot = tot + __ldcg(part + b);
  const float gn = sqrtf(warp_sum(tot));
  AdamStep st;
  st.scale = gn > ac.clip ? ac.clip / gn : 1.0f;
  st.lr = ac.anneal ? ac.lr * (1.0f - fminf(cnt / ac.total_steps, 1.0f))
                    : ac.lr;
  const float c = cnt + 1.0f;
  st.bc1 = 1.0f - expf(c * ac.log_b1);
  st.bc2 = 1.0f - expf(c * ac.log_b2);
#pragma unroll
  for (int h = 0; h < 2; ++h)
    adam_apply(theta, mu, nu, e0[h], P, vec, ac, st, g[h], m[h], v[h], w[h]);
  for (int s = blockIdx.x + G; s < (P + ADAM_SLICE - 1) / ADAM_SLICE; s += G) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = s * ADAM_SLICE + 4 * (threadIdx.x + h * ADAM_THREADS);
      float gs[4], ms[4], vs[4], ws[4];
      adam_load(theta, grads, mu, nu, e, P, vec, gs, ms, vs, ws);
      adam_apply(theta, mu, nu, e, P, vec, ac, st, gs, ms, vs, ws);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) count[0] = c;
}

}  // namespace drone

// C interface (ctypes). Device pointers: planes, advret, perm, theta,
// wplanes (the fp32 arm's 2 wf floats: the split weights; the bf16 arm's
// 4 wq: its fragments), scratch (the blocks' rows when not on chip: (G, sf)
// running sums, the bf16 arm's (G, sf + yrows * 64) with its fp32 tanh
// rows; else unused), partial ((G, P + 8) scratch), grads (P), stats (8).
// Host: layout ints [n_hidden, width[UPD_HIDDEN], actor W
// offsets[UPD_HIDDEN + 1], critic W offsets[UPD_HIDDEN + 1], P, ls_off];
// consts floats [inv_m, clip_lo, clip_hi, clip_eps, vf_clip, half_vf_coef,
// ent_coef]; dims ints [dynamic shared memory bytes, on chip (0 or 1), wf
// (the bf16 arm: wq), the floats of a block's scratch row (the fp32 arm:
// sf; the bf16 arm's on chip: 0)],
// which must be the kernel's own (ops/cuda_update.py mma_layout,
// b16_layout); bf16: 1 for the bf16 arm (G up to B16_MAX_BLOCKS), 0 for
// 3xTF32 (G up to MAX_BLOCKS). Returns the cudaError_t of the launches.
extern "C" int drone_ppo_update(const float* planes, const float* advret,
                                const int* perm, const float* theta,
                                float* wplanes, float* scratch,
                                float* partial, float* grads, float* stats,
                                const int* layout, const float* consts,
                                const int* dims, int n, int T, int rbl,
                                int n_sel, int G, int bf16, void* stream) {
  using namespace drone;
  const int L = layout[0];
  if (n <= 0 || T <= 0 || n_sel <= 0 || rbl % TILE != 0 || L < 0 ||
      L > UPD_HIDDEN || bf16 < 0 || bf16 > 1)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l)
    if (layout[1 + l] <= 0) return (int)cudaErrorInvalidValue;
  const int* wa = layout + 1 + UPD_HIDDEN;
  const int* wc = layout + 2 + 2 * UPD_HIDDEN;
  UArgs A{planes, advret, perm, theta, wplanes, scratch, partial, n, T, rbl,
          n_sel * (rbl / TILE) * T, layout[3 + 3 * UPD_HIDDEN],
          layout[4 + 3 * UPD_HIDDEN]};
  if (G <= 0 || G > (bf16 ? B16_MAX_BLOCKS : MAX_BLOCKS) || G > A.n_tiles)
    return (int)cudaErrorInvalidValue;
  const UConsts co{consts[0], consts[1], consts[2], consts[3],
                   consts[4], consts[5], consts[6]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    BLayout lo;
    make_layout_b16(L, layout + 1, wa, wc, lo);
    const bool onchip =
        layout_smem_b16(lo, true) + B16_STATIC_BYTES <= UPD_MAX_SMEM;
    const size_t smem = layout_smem_b16(lo, onchip);
    if (smem + B16_STATIC_BYTES > UPD_MAX_SMEM || (size_t)dims[0] != smem ||
        dims[1] != (int)onchip || dims[2] != lo.wq ||
        dims[3] != (onchip ? 0 : lo.sf + lo.yrows * TILE))
      return (int)cudaErrorInvalidValue;
    pack_b16_kernel<<<(lo.wq + 255) / 256, 256, 0, s>>>(
        theta, lo, reinterpret_cast<uint4*>(wplanes));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    void (*kernel)(UArgs, BLayout, UConsts) = update_kernel<false, true>;
    if (onchip) kernel = update_kernel<true, true>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<G, UPD_THREADS, smem, s>>>(A, lo, co);
  } else {
    MLayout lo;
    make_layout(L, layout + 1, wa, wc, lo);
    const bool onchip = layout_smem(lo, true) + STAT_PART_BYTES <= UPD_MAX_SMEM;
    const size_t smem = layout_smem(lo, onchip);
    if (smem + STAT_PART_BYTES > UPD_MAX_SMEM || (size_t)dims[0] != smem ||
        dims[1] != (int)onchip || dims[2] != lo.wf || dims[3] != lo.sf)
      return (int)cudaErrorInvalidValue;
    pack_planes_kernel<<<(lo.wf + 255) / 256, 256, 0, s>>>(theta, lo, wplanes);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    void (*kernel)(UArgs, MLayout, UConsts) = update_kernel<false, false>;
    if (onchip) kernel = update_kernel<true, false>;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<G, UPD_THREADS, smem, s>>>(A, lo, co);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int PW = A.P + N_UPSTATS;
  reduce_kernel<<<(PW + 255) / 256, 256, 0, s>>>(partial, G, A.P, A.ls_off,
                                                 co.ent_coef, grads, stats);
  return (int)cudaGetLastError();
}

// theta, grads, mu, nu (P floats), count (1 float) and part (one float a
// block) are device memory; consts: host floats [lr, total_steps, b1, b2,
// eps, clip, log_b1, log_b2]; anneal: 0 or 1; blocks: min(ceil(P /
// ADAM_SLICE), ADAM_MAX_BLOCKS) (ops/cuda_update.py adam_blocks), P at most
// ADAM_MAX_P.
// Updates theta, mu, nu and count in place: one cooperative launch, so
// every block of the grid is resident at its barrier.
extern "C" int drone_fused_adam(float* theta, const float* grads, float* mu,
                                float* nu, float* count, float* part, int P,
                                int blocks, const float* consts, int anneal,
                                void* stream) {
  using namespace drone;
  const int want = (P + ADAM_SLICE - 1) / ADAM_SLICE;
  if (P <= 0 || P > ADAM_MAX_P ||
      blocks != (want < ADAM_MAX_BLOCKS ? want : ADAM_MAX_BLOCKS))
    return (int)cudaErrorInvalidValue;
  AdamC ac{consts[0], consts[1], consts[2], consts[3], consts[4],
           consts[5], consts[6], consts[7], anneal};
  void* args[] = {&theta, &grads, &mu, &nu, &count, &part, &P, &ac};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(adam_kernel), dim3(blocks), dim3(ADAM_THREADS),
      args, 0, static_cast<cudaStream_t>(stream));
}
