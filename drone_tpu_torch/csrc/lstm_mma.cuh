// lstm_mma.cuh — the LSTM gate block, and its backward product, on the
// tensor cores in 3xTF32 (cnn_mma.cuh's operand split and mma.sync
// m16n8k8), for every recurrent kernel: the acting kernels' both arms
// (acting_lstm.cu: K8 and K6) and the walk through time of the update
// (update_lstm.cu: K7, both arms), over tiles of TM_L = 64 lanes whose rows
// lie TM_S = 72 floats apart in shared memory.
//
// Ports drone_tpu/ops/pallas_acting_lstm.py `lstm_gates` (flax
// OptimizedLSTMCell):
//   i = sig(x Wi_i + h Wh_i + b_i)   f = sig(...)   g = tanh(...)   o = sig(...)
//   c' = f*c + i*g ;  h' = o*tanh(c')
// and, for K7, the input gradient of its pre-activations: [dx; dh] = dz
// [Wi; Wh]^T (drone_tpu/ops/pallas_update_lstm.py `_segment_grads`).
//
// Forward: the product of the tile's (x; h) rows (64 lanes x Ep + Hp) with
// the gate weights (Ep + Hp, 4 Hp). pack_gates_kernel orders the 4 Hp gate
// columns so that n-tiles 4 ug .. 4 ug + 3 are the i, f, g and o gates of
// units 8 ug .. 8 ug + 7. A hidden that is not a multiple of 8 pads Hp with
// zero units (their weights and biases are zero, so their c and h stay 0),
// an input width that is not (E = 13 with no encoder, widths like 36) pads
// Ep with zero rows of x. A warp takes one unit group at a time for all 64
// lanes (4 m-tiles x 4 n-tiles: each B fragment serves the whole tile,
// read by one warp), so a thread's accumulators hold all four gates of its
// (lane, unit) pairs (lane 16 i + g + 8 (r >> 1), unit 8 ug + 2 t + (r & 1)
// of fragment r of m-tile i) and it runs their cell update (c' where the
// kernel keeps c: in shared memory in the acting kernels, in the owner's
// registers in K7's walk), h' kept in registers until every thread has read
// h, then over the h rows.
//
// Backward (K7): dz (64 lanes x 4 Hp, its rows in the forward's column
// order) times the transposed fragments (pack_gates_t_kernel: K = the
// gate columns, N = the Ep + Hp input rows). Warp w takes the n-tiles of
// its unit groups' recurrent rows, so its dh accumulators are its own
// (lane, unit) pairs of the forward's ownership, and dh and dc stay in its
// registers across the walk; dx goes to shared memory for the encoder's
// backward.
//
// What bounds it on an H100: 4 Hp (Ep + Hp) multiply-adds a lane-step each
// way (98,304 at H 128 / E 64) at the 3xTF32 rate, and the (big, small)
// fragments, 786,432 bytes at H 128 / E 64 (1 MB at E 128), read from L2
// once a tile-step by each product: 12,288 bytes a lane-step at 64 lanes.
//
// Precision: the gates' sums (Ep + Hp long) and dz's (4 Hp) accumulate in
// the tensor cores' fp32 accumulators, a product's error ~2^-21 of its
// size; K8 and K6 are held to their fp32 plain versions at the serving
// tolerance (rtol 2e-5, atol 2e-6 over 3 steps), K7 at the update's (1e-4
// of each gradient tensor's max).
//
// The bf16 arm (K7's compute_dtype="bfloat16": the reference's lstm_gates
// and _segment_grads with _dot32 rounding both operands): the BF16
// template parameter of the packers and the products (mma.cuh split_op,
// mma_op). The packers write each weight rounded to bf16 as big (small 0,
// unread), x, h and dz are rounded as their fragments load, and each
// k-step is one TF32 product, exact in fp32. K8 and K6 run BF16 = false.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "cnn_mma.cuh"
#include "lstm.cuh"

namespace drone {

constexpr int GATE_WARPS = TM_THREADS / 32;
constexpr int GATE_PASSES = LSTM_MAX_H / 8 / GATE_WARPS;  // unit groups a warp

// The gate block's units: H rounded up to a multiple of 8.
__host__ __device__ constexpr int gate_units(int H) { return (H + 7) / 8 * 8; }
// ... and its input rows: E rounded up to a multiple of 8.
__host__ __device__ constexpr int gate_inputs(int E) { return (E + 7) / 8 * 8; }

// The packed gate fragments' float4s: (Ep + Hp) / 8 k-tiles x Hp / 2
// n-tiles x 32 lanes.
__host__ __device__ constexpr int gate_frags(int E, int H) {
  return (gate_inputs(E) + gate_units(H)) * gate_units(H) * 2;
}

// The transposed fragments' n-tiles and float4s: Hp / 2 k-tiles x (Ep +
// Hp) / 8 n-tiles x 32 lanes.
__host__ __device__ constexpr int gate_t_ntiles(int E, int H) {
  return (gate_inputs(E) + gate_units(H)) / 8;
}
__host__ __device__ constexpr int gate_t_frags(int E, int H) {
  return gate_units(H) / 2 * gate_t_ntiles(E, H) * 32;
}

// WP's row (E + H, H, 4) of the gate block's input row k (x's Ep, then h's
// Hp), or -1 for a padded row.
__device__ __forceinline__ int gate_row(int k, int E, int H) {
  const int Ep = gate_inputs(E);
  if (k < Ep) return k < E ? k : -1;
  return k - Ep < H ? E + k - Ep : -1;
}

// One packed float4 (cnn_mma.cuh pack_tower_kernel's layout) of B[k][n] and
// B[k + 4][n], v holding them (BF16: rounded, small 0).
template <bool BF16>
__device__ __forceinline__ float4 pack_pair(const float (&v)[2]) {
  uint32_t b0, s0, b1, s1;
  split_op<BF16>(v[0], b0, s0);
  split_op<BF16>(v[1], b1, s1);
  return make_float4(__uint_as_float(b0), __uint_as_float(b1),
                     __uint_as_float(s0), __uint_as_float(s1));
}

// The (big, small) fragments of the gate weights (gate_frags float4s) from
// WP (E + H, H, 4): B[k][n], n = 32 ug + 8 gate + j, is WP[gate_row(k)][8 ug
// + j][gate], 0 for a padded unit or row.
template <bool BF16>
__global__ void pack_gates_kernel(const float* __restrict__ wp, int E, int H,
                                  float4* __restrict__ pg) {
  const int NT = gate_units(H) / 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= gate_frags(E, H)) return;
  const int lane = i % 32, tile = i / 32, kt = tile / NT, nt = tile % NT;
  const int n = 8 * nt + lane / 4, k = 8 * kt + lane % 4;
  const int u = 8 * (n / 32) + n % 8, gate = (n / 8) % 4;
  float v[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gate_row(k + 4 * r, E, H);
    v[r] = u < H && row >= 0 ? wp[((size_t)row * H + u) * 4 + gate] : 0.0f;
  }
  pg[i] = pack_pair<BF16>(v);
}

// The transposed fragments (gate_t_frags float4s) for dz [Wi; Wh]^T: B[k][n]
// with k = 32 ug + 8 gate + j (the forward's column order: unit 8 ug + j)
// and n the gate block's input row (x's Ep, then h's Hp).
template <bool BF16>
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
  pgt[i] = pack_pair<BF16>(v);
}

// The acting kernels' cell update of lstm_gates_mma: c in shared memory
// ([unit][lane] at stride TM_S, Hp rows), c' over it.
struct SharedCell {
  float* c;
  __device__ float operator()(int, int, int, int u, int l, float gi, float gf,
                              float gg, float go) const {
    float* cp = c + u * TM_S + l;
    const float c2 = gf * *cp + gi * gg;
    *cp = c2;
    return go * tanhf(c2);
  }
};

// The (lane, unit) pair of fragment r of m-tile i in warp w's pass p of the
// gate block: the pairs a thread owns.
__device__ __forceinline__ int owned_lane(int i, int r) {
  return 16 * i + ((threadIdx.x & 31) >> 2) + (r & 2 ? 8 : 0);
}
__device__ __forceinline__ int owned_unit(int p, int r) {
  return 8 * ((threadIdx.x >> 5) + GATE_WARPS * p) + 2 * (threadIdx.x & 3)
         + (r & 1);
}

// The gate block of one step for the tile's TM_L lanes: x (Ep rows, those
// past E zero) and h (Hp rows), [row][lane] at stride TM_S; PG the packed
// gate fragments, BP the recurrent biases (H, 4). For each (lane, unit)
// pair it owns, a thread calls cell(p, i, r, u, l, gi, gf, gg, go), which
// updates the pair's c (wherever the kernel keeps it) and returns h'; after
// a barrier h' goes over h. Warp w takes unit groups w, w + 8, ...; the
// next k-step's fragments load while one multiplies (48 products a k-step;
// two ahead was slower, PERF.md). The caller needs a barrier before it
// reads h'. All threads. BF16: PG packed by pack_gates_kernel<true>, x and
// h rounded as they load.
template <bool BF16 = false, class Cell>
__device__ __forceinline__ void lstm_gates_mma(const float* x, float* h,
                                               int E, int H,
                                               const float4* __restrict__ PG,
                                               const float4* __restrict__ BP,
                                               Cell&& cell) {
  const int Ep = gate_inputs(E), Hp = gate_units(H);
  const int NT = Hp / 2, UG = Hp / 8;
  const int w = threadIdx.x >> 5;
  float hn[GATE_PASSES][4][4];
#pragma unroll
  for (int p = 0; p < GATE_PASSES; ++p) {
    const int ug = w + GATE_WARPS * p;
    if (ug >= UG) continue;
    float acc[4][4][4];  // [m-tile][gate][fragment]
    zero_frags(acc);
    mma_rows_packed<1, false, BF16>(x, Ep, 0, PG, NT, 0, 4 * ug, acc);
    mma_rows_packed<1, false, BF16>(h, Hp, 0, PG, NT, Ep / 8, 4 * ug, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int u = owned_unit(p, r);
        const float4 b = u < H ? __ldg(BP + u)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        hn[p][i][r] = cell(p, i, r, u, owned_lane(i, r),
                           sigmoidf(acc[i][0][r] + b.x),
                           sigmoidf(acc[i][1][r] + b.y),
                           tanhf(acc[i][2][r] + b.z),
                           sigmoidf(acc[i][3][r] + b.w));
      }
  }
  __syncthreads();  // every thread has read h
#pragma unroll
  for (int p = 0; p < GATE_PASSES; ++p) {
    if (w + GATE_WARPS * p >= UG) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        h[owned_unit(p, r) * TM_S + owned_lane(i, r)] = hn[p][i][r];
  }
}

// acc[i][j] (lanes m0 + 16 i .., n-tile nt[j]) += sum over the K rows of X
// of X[k][lane] B[k][n], B packed (NT n-tiles a k-tile): mma_rows_packed
// for n-tiles that need not be side by side, so that one A fragment serves
// them all. The next k-step's fragments load while one multiplies. BF16:
// one product a k-step of X rounded and B packed rounded.
template <bool BF16 = false, int MI, int NI>
__device__ __forceinline__ void mma_rows_tiles(const float* X, int K, int m0,
                                               const float4* __restrict__ B,
                                               int NT, const int (&nt)[NI],
                                               float (&acc)[MI][NI][4]) {
  const float4* bp[NI];
  float4 wv[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    bp[j] = B + (size_t)nt[j] * 32 + (threadIdx.x & 31);
    wv[j] = __ldg(bp[j]);
  }
#pragma unroll 2
  for (int k = 0; k < K; k += 8) {
    uint32_t bb[NI][2], bs[NI][2];
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      bb[j][0] = __float_as_uint(wv[j].x);
      bb[j][1] = __float_as_uint(wv[j].y);
      bs[j][0] = __float_as_uint(wv[j].z);
      bs[j][1] = __float_as_uint(wv[j].w);
    }
    if (k + 8 < K) {
#pragma unroll
      for (int j = 0; j < NI; ++j)
        wv[j] = __ldg(bp[j] + (size_t)(k / 8 + 1) * NT * 32);
    }
    uint32_t ab[MI][4], as[MI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
      frag_a_rows<BF16>(X, k, m0 + 16 * i, ab[i], as[i]);
    mma_op<BF16>(acc, ab, as, bb, bs);
  }
}

// The backward product of one step: dz (4 Hp rows in the forward's column
// order, [row][lane] at stride TM_S) times the transposed fragments PGT.
// dh[p][i][r] gets the pair (owned_lane(i, r), owned_unit(p, r)), the
// forward's ownership (a padded unit group reads group 0's rows, and its
// pairs are never used); with want_dx, dx's Ep rows go to dx ([row][lane],
// stride TM_S), warp w taking n-tiles w, w + 8, ...: the first beside dh's
// in one pass over dz (one A fragment for three n-tiles), any others
// alone. All threads; no barrier. BF16: PGT packed by
// pack_gates_t_kernel<true>, dz rounded as it loads.
template <bool BF16 = false>
__device__ __forceinline__ void gates_bwd_mma(
    const float* dz, int E, int H, const float4* __restrict__ PGT,
    bool want_dx, float* dx, float (&dh)[GATE_PASSES][4][4]) {
  const int Ep = gate_inputs(E), Hp = gate_units(H), K = 4 * Hp;
  const int NT = gate_t_ntiles(E, H), NX = Ep / 8, UG = Hp / 8;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // n-tile d of dx from column j of accumulators a
  auto store_dx = [&](int d, const auto& a, int j) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dx[(8 * d + 2 * t + (r & 1)) * TM_S + 16 * i + g + (r & 2 ? 8 : 0)] =
            a[i][j][r];
  };
  int nt[GATE_PASSES + 1];
#pragma unroll
  for (int p = 0; p < GATE_PASSES; ++p) {
    const int ug = w + GATE_WARPS * p;
    nt[p] = NX + (ug < UG ? ug : 0);
  }
  nt[GATE_PASSES] = want_dx && w < NX ? w : nt[0];
  float acc[4][GATE_PASSES + 1][4];
  zero_frags(acc);
  mma_rows_tiles<BF16>(dz, K, 0, PGT, NT, nt, acc);
#pragma unroll
  for (int p = 0; p < GATE_PASSES; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) dh[p][i][r] = acc[i][p][r];
  if (!want_dx) return;
  if (w < NX) store_dx(w, acc, GATE_PASSES);
  for (int d = w + GATE_WARPS; d < NX; d += GATE_WARPS) {
    const int n1[1] = {d};
    float a1[4][1][4];
    zero_frags(a1);
    mma_rows_tiles<BF16>(dz, K, 0, PGT, NT, n1, a1);
    store_dx(d, a1, 0);
  }
}

}  // namespace drone
