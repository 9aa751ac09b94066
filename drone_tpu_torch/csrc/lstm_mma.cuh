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
// order) times the transposed fragments (update_lstm.cu
// pack_gates_t_kernel: K = the gate columns, N = the Ep + Hp input rows).
// Warp w takes the n-tiles of its unit groups' recurrent rows, so its dh
// accumulators are its own (lane, unit) pairs of the forward's ownership,
// and dh and dc stay in its registers across the walk; dx goes to shared
// memory for the encoder's backward.
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
// and _segment_grads with _dot32 rounding both operands): lstm_gates_b16
// and gates_bwd_b16 below, on the bf16 tensor cores (m16n8k16) from
// operands stored once as bf16. K8 and K6 run the fp32 functions alone.
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
// B[k + 4][n], v holding them.
__device__ __forceinline__ float4 pack_pair(const float (&v)[2]) {
  uint32_t b0, s0, b1, s1;
  split_tf32(v[0], b0, s0);
  split_tf32(v[1], b1, s1);
  return make_float4(__uint_as_float(b0), __uint_as_float(b1),
                     __uint_as_float(s0), __uint_as_float(s1));
}

// The (big, small) fragments of the gate weights (gate_frags float4s) from
// WP (E + H, H, 4): B[k][n], n = 32 ug + 8 gate + j, is WP[gate_row(k)][8 ug
// + j][gate], 0 for a padded unit or row.
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
  pg[i] = pack_pair(v);
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
// reads h'. All threads.
template <class Cell>
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
    mma_rows_packed<1, false>(x, Ep, 0, PG, NT, 0, 4 * ug, acc);
    mma_rows_packed<1, false>(h, Hp, 0, PG, NT, Ep / 8, 4 * ug, acc);
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
// them all. The next k-step's fragments load while one multiplies.
template <int MI, int NI>
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
      frag_a_rows(X, k, m0 + 16 * i, ab[i], as[i]);
    mma3(acc, ab, as, bb, bs);
  }
}

// The backward product of one step: dz (4 Hp rows in the forward's column
// order, [row][lane] at stride TM_S) times the transposed fragments PGT.
// dh[p][i][r] gets the pair (owned_lane(i, r), owned_unit(p, r)), the
// forward's ownership (a padded unit group reads group 0's rows, and its
// pairs are never used); with want_dx, dx's Ep rows go to dx ([row][lane],
// stride TM_S), warp w taking n-tiles w, w + 8, ...: the first beside dh's
// in one pass over dz (one A fragment for three n-tiles), any others
// alone. All threads; no barrier.
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
  mma_rows_tiles(dz, K, 0, PGT, NT, nt, acc);
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
    mma_rows_tiles(dz, K, 0, PGT, NT, n1, a1);
    store_dx(d, a1, 0);
  }
}

// ---- K7's bf16 walk: the bf16 tensor cores, operands stored once --------
// The gate block and its backward product of the bf16 arm: mma.sync
// m16n8k16 (mma.cuh mma_bf16) of operands stored once as bf16, each product
// of two bf16 values exact, 16 of them added in a group before the fp32
// accumulator (H10, H12). x, h and dz are bf16 rows of the tile (lane l at
// column l, TMB apart), their A fragments loaded by ldmatrix.trans
// (cnn_mma.cuh mma_rows_b16's addressing); the gate weights are bf16x2
// fragments (update_lstm.cu pack_gates_b16_kernel: the {b0, b1} pairs of a
// unit group's four n-tiles in two uint4s a lane a k-tile of 16;
// pack_gates_t_b16_kernel: an n-tile's pair in a uint2), which reach a warp
// through a ring of B16_RING k-tiles in shared memory (its own: no
// barrier) that cp.async fills B16_AHEAD k-tiles ahead: with one k-step of
// fragments in flight the products waited on L2's latency, not its bytes.
// The fp32 functions' ownership, callback and k order (x's rows, then h's,
// K padded to 16 with zero rows).
constexpr int B16_RING = 4;
constexpr int B16_AHEAD = 3;
// a warp's ring: B16_RING slots of 32 bytes a lane (the forward's four
// n-tiles; the backward's three take 24)
constexpr int B16_RING_BYTES = B16_RING * 32 * 32;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// every group but the newest n has landed (this thread's copies)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// A bf16 value as fp32.
__device__ __forceinline__ float b16_value(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

// This lane's ldmatrix.trans row in bf16 rows X (k-major, TMB apart): k
// (lane & 7) + 8 (lane >> 4) of lanes 8 ((lane >> 3) & 1) ..; m-tile i of
// k-tile k at + 16 (k TMB + i).
__device__ __forceinline__ const uint16_t* b16_rows(const uint16_t* X) {
  const int lane = threadIdx.x & 31;
  return X + ((lane & 7) + 8 * (lane >> 4)) * TMB + 8 * ((lane >> 3) & 1);
}

// acc[i][q] += sum over nk k-tiles of X (bf16 rows from row 0) of X[k][lane]
// B[k][n-tile q of the unit group], bp the lane's two uint4s of k-tile 0,
// k-tiles `step` uint4s apart.
__device__ __forceinline__ void mma_b16_gates(const uint16_t* X, int nk,
                                              const uint4* __restrict__ bp,
                                              int step, uint4* ring,
                                              float (&acc)[4][4][4]) {
  const int lane = threadIdx.x & 31;
  const uint16_t* xp = b16_rows(X);
  auto copy = [&](int k) {
    if (k < nk) {
      uint4* d = ring + ((k % B16_RING) * 32 + lane) * 2;
      const uint4* src = bp + (size_t)k * step;
      cp_async16(d, src);
      cp_async16(d + 1, src + 1);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < B16_AHEAD; ++k) copy(k);
  for (int k = 0; k < nk; ++k) {
    copy(k + B16_AHEAD);
    cp_async_wait<B16_AHEAD>();
    const uint4* r = ring + ((k % B16_RING) * 32 + lane) * 2;
    const uint4 w0 = r[0], w1 = r[1];
    const uint32_t bb[4][2] = {{w0.x, w0.y}, {w0.z, w0.w},
                               {w1.x, w1.y}, {w1.z, w1.w}};
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ldsm_x4_t(a[i], xp + 16 * (k * TMB + i));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) mma_bf16(acc[i][q], a[i], bb[q]);
  }
}

// lstm_gates_mma from bf16 rows: x (Ep rows, those past E zero), then h (Hp
// rows) and zero rows up to a multiple of 16, PG packed by
// pack_gates_b16_kernel, ring the warp's B16_RING_BYTES; h' goes over h as
// bf16 after the barrier.
template <class Cell>
__device__ __forceinline__ void lstm_gates_b16(const uint16_t* x, uint16_t* h,
                                               int E, int H,
                                               const uint4* __restrict__ PG,
                                               const float4* __restrict__ BP,
                                               uint4* ring, Cell&& cell) {
  const int Ep = gate_inputs(E), Hp = gate_units(H), UG = Hp / 8;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float hn[GATE_PASSES][4][4];
#pragma unroll
  for (int p = 0; p < GATE_PASSES; ++p) {
    const int ug = w + GATE_WARPS * p;
    if (ug >= UG) continue;
    float acc[4][4][4];  // [m-tile][gate][fragment]
    zero_frags(acc);
    mma_b16_gates(x, (Ep + Hp + 15) / 16, PG + (ug * 32 + lane) * 2, UG * 64,
                  ring, acc);
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
        h[owned_unit(p, r) * TMB + owned_lane(i, r)] = bf16_bits(hn[p][i][r]);
  }
}

// acc[i][j] += sum over the K rows of X (bf16 rows) of X[k][lane] B[k][n-tile
// nt[j]], B as pack_gates_t_b16_kernel's uint2s (NT n-tiles a k-tile of
// 16).
template <int NI>
__device__ __forceinline__ void mma_b16_tiles(const uint16_t* X, int K,
                                              const uint2* __restrict__ B,
                                              int NT, const int (&nt)[NI],
                                              uint2* ring,
                                              float (&acc)[4][NI][4]) {
  const int lane = threadIdx.x & 31, nk = K / 16;
  const uint16_t* xp = b16_rows(X);
  const uint2* bp[NI];
#pragma unroll
  for (int j = 0; j < NI; ++j) bp[j] = B + (size_t)nt[j] * 32 + lane;
  auto copy = [&](int k) {
    if (k < nk) {
#pragma unroll
      for (int j = 0; j < NI; ++j)
        cp_async8(ring + ((k % B16_RING) * NI + j) * 32 + lane,
                  bp[j] + (size_t)k * NT * 32);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < B16_AHEAD; ++k) copy(k);
  for (int k = 0; k < nk; ++k) {
    copy(k + B16_AHEAD);
    cp_async_wait<B16_AHEAD>();
    uint32_t bb[NI][2];
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const uint2 v = ring[((k % B16_RING) * NI + j) * 32 + lane];
      bb[j][0] = v.x;
      bb[j][1] = v.y;
    }
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ldsm_x4_t(a[i], xp + 16 * (k * TMB + i));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], a[i], bb[j]);
  }
}

// gates_bwd_mma from dz's bf16 rows (4 Hp, the forward's column order),
// PGT packed by pack_gates_t_b16_kernel, ring the warp's B16_RING_BYTES: dh
// and dx (fp32, [row][lane] at stride TM_S) as gates_bwd_mma's.
__device__ __forceinline__ void gates_bwd_b16(
    const uint16_t* dz, int E, int H, const uint2* __restrict__ PGT,
    bool want_dx, float* dx, uint2* ring, float (&dh)[GATE_PASSES][4][4]) {
  const int Ep = gate_inputs(E), Hp = gate_units(H), K = 4 * Hp;
  const int NT = gate_t_ntiles(E, H), NX = Ep / 8, UG = Hp / 8;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
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
  mma_b16_tiles(dz, K, PGT, NT, nt, ring, acc);
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
    mma_b16_tiles(dz, K, PGT, NT, n1, ring, a1);
    store_dx(d, a1, 0);
  }
}

}  // namespace drone
