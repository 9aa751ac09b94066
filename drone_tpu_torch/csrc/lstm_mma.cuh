// lstm_mma.cuh — the gate block of the recurrent acting kernels' CNN arm
// (acting_lstm.cu: K8 and K6 with ENC_CNN) on the tensor cores in 3xTF32
// (cnn_mma.cuh's operand split and mma.sync m16n8k8): the product of the
// tile's (x; h) rows (64 lanes x E + Hp) with the gate weights (E + Hp,
// 4 Hp), then the cell update. The dense arm keeps lstm.cuh's fp32
// lstm_gates.
//
// Ports drone_tpu/ops/pallas_acting_lstm.py `lstm_gates` (flax
// OptimizedLSTMCell), as lstm.cuh's lstm_gates does:
//   i = sig(x Wi_i + h Wh_i + b_i)   f = sig(...)   g = tanh(...)   o = sig(...)
//   c' = f*c + i*g ;  h' = o*tanh(c')
//
// Columns: pack_gates_kernel orders the 4 Hp gate columns so that n-tiles
// 4 ug .. 4 ug + 3 are the i, f, g and o gates of units 8 ug .. 8 ug + 7.
// A hidden that is not a multiple of 8 pads Hp with zero units: their
// weights and biases are zero, so their c and h stay 0. A warp takes one
// unit group at a time for all 64 lanes (4 m-tiles x 4 n-tiles: each B
// fragment serves the whole tile, read by one warp), so a thread's
// accumulators hold all four gates of its (lane, unit) pairs and it runs
// their cell update in registers: c' over the c rows (each (lane, unit)
// owned by one thread), h' kept in registers until every thread has read
// h, then over the h rows.
//
// What bounds it on an H100: 4 Hp (E + Hp) multiply-adds a lane-step
// (131,072 at E = H = 128) at the 3xTF32 rate, and the weights' (big,
// small) fragments, 1 MB at E = H = 128, from L2 once a tile-step: 16 KB a
// lane-step, which the 64-lane tile cannot amortise further within a
// block's shared memory beside the tower's and the carry's rows.
//
// Precision: the gates' 256-long sums accumulate in the tensor cores' fp32
// accumulators, a product's error ~2^-21 of its size; K8 and K6 are held to
// their fp32 plain versions at the serving tolerance (rtol 2e-5, atol 2e-6
// over 3 steps).
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

// The packed gate fragments' float4s: (E + Hp) / 8 k-tiles x Hp / 2
// n-tiles x 32 lanes.
__host__ __device__ constexpr int gate_frags(int E, int H) {
  return (E + gate_units(H)) * gate_units(H) * 2;
}

// The (big, small) fragments of the gate weights (gate_frags float4s, the
// layout of cnn_mma.cuh pack_tower_kernel) from WP (E + H, H, 4): B[k][n],
// n = 32 ug + 8 gate + j, is WP[k][8 ug + j][gate] (the input kernels' rows
// k < E, then the recurrent ones'), 0 for a padded unit or row.
__global__ void pack_gates_kernel(const float* __restrict__ wp, int E, int H,
                                  float4* __restrict__ pg) {
  const int Hp = gate_units(H), NT = Hp / 2;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= gate_frags(E, H)) return;
  const int lane = i % 32, tile = i / 32, kt = tile / NT, nt = tile % NT;
  const int n = 8 * nt + lane / 4, k = 8 * kt + lane % 4;
  const int u = 8 * (n / 32) + n % 8, gate = (n / 8) % 4;
  float v[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kk = k + 4 * r;
    v[r] = u < H && kk < E + H ? wp[((size_t)kk * H + u) * 4 + gate] : 0.0f;
  }
  uint32_t b0, s0, b1, s1;
  split_tf32(v[0], b0, s0);
  split_tf32(v[1], b1, s1);
  pg[i] = make_float4(__uint_as_float(b0), __uint_as_float(b1),
                      __uint_as_float(s0), __uint_as_float(s1));
}

// The gate block of one step for the tile's TM_L lanes: x (E rows) and h
// (Hp rows) and c (Hp rows), all [row][lane] at stride TM_S; PG the packed
// gate fragments, BP the recurrent biases (H, 4). Writes c' over c and,
// after a barrier, h' over h. Warp w takes unit groups w, w + 8, ...; the
// next k-step's fragments load while one multiplies (48 products a
// k-step; two ahead was slower, PERF.md). The caller needs a barrier
// before it reads h'. All threads.
__device__ __forceinline__ void lstm_gates_mma(const float* x, float* h,
                                               float* c, int E, int H,
                                               const float4* __restrict__ PG,
                                               const float4* __restrict__ BP) {
  const int Hp = gate_units(H), NT = Hp / 2, UG = Hp / 8;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float hn[GATE_PASSES][4][4];
#pragma unroll
  for (int p = 0; p < GATE_PASSES; ++p) {
    const int ug = w + GATE_WARPS * p;
    if (ug >= UG) continue;
    float acc[4][4][4];  // [m-tile][gate][fragment]
    zero_frags(acc);
    mma_rows_packed<1>(x, E, 0, PG, NT, 0, 4 * ug, acc);
    mma_rows_packed<1>(h, Hp, 0, PG, NT, E / 8, 4 * ug, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = 16 * i + g + (r & 2 ? 8 : 0);
        const int u = 8 * ug + 2 * t + (r & 1);
        const float4 b = u < H ? __ldg(BP + u)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float gi = sigmoidf(acc[i][0][r] + b.x);
        const float gf = sigmoidf(acc[i][1][r] + b.y);
        const float gg = tanhf(acc[i][2][r] + b.z);
        const float go = sigmoidf(acc[i][3][r] + b.w);
        float* cp = c + u * TM_S + l;
        const float c2 = gf * *cp + gi * gg;
        *cp = c2;
        hn[p][i][r] = go * tanhf(c2);
      }
  }
  __syncthreads();  // every thread has read h
#pragma unroll
  for (int p = 0; p < GATE_PASSES; ++p) {
    const int ug = w + GATE_WARPS * p;
    if (ug >= UG) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        h[(8 * ug + 2 * t + (r & 1)) * TM_S + 16 * i + g + (r & 2 ? 8 : 0)] =
            hn[p][i][r];
  }
}

}  // namespace drone
