// update_cnn.cu — the CNN PPO update (K10): one minibatch of the patch-CNN
// policy's forward and hand-written backward, its gradients and the 8 stat
// sums.
//
// Replaces drone_tpu/ops/pallas_update_cnn.py `_cnn_update_kernel` (driven
// by `ppo_cnn_update`). Wrapper and plain version: ops/cuda_update_cnn.py.
//
// The pixels are never stored, in either direction: each tile re-renders
// its conv0 patches from the stored obs planes, as the reference does. The
// minibatch's steps go in chunks (the scratch of one chunk is ~0.7 GB at
// 16,384 lanes x 16 steps); per chunk two kernels run:
//   tile_kernel: a block of 256 threads takes fixed tiles of 32 samples (32
//     lanes of one row block at one step). Per tile it runs the forward
//     window by window (cnn.cuh), storing each window's conv1 output (the
//     trunk's input X2) in a device scratch; the heads and the PPO head's
//     gradients per sample (policy.cuh head_grads, K3's); dzt = dh * (h > 0),
//     also to the scratch; then window by window again: re-render the four
//     patches and re-run conv0, dX2 = Wt^T dzt masked by conv1's relu (dz1),
//     gW1 += dz1 X1^T, dX1 = W1^T dz1 masked by conv0's relu (dz0), gW0 +=
//     dz0 X0^T. gW0, gW1 (80 KB), their biases and the heads' gradients
//     accumulate in the block's shared memory over its tiles (each entry
//     always by the same thread), then go to the block's own partial row.
//   cnn_gemm_kernel (K7's product): gWt and gbt as a split-K product of the
//     scratch's dzt (128 rows) and X2 (576 rows) over the chunk's samples,
//     each (tile, chunk) block writing its own partial row.
// A last kernel adds the partial rows in a fixed order. No float atomics:
// two launches on the same inputs give the same bits, so training on the
// card is deterministic and a resume repeats a run (H6).
//
// What bounds it on an H100: per sample ~1.1 M multiply-adds (the forward
// 369k, conv0 again 147k, dX2 74k, gW1 147k, dX1 147k, gW0 147k, gWt 74k)
// and 4,608 expf on the fp32 cores; the planes and the scratch's traffic
// are far below the memory rate's share.

#include <cuda_runtime.h>

#include <cstdint>

#include "cnn.cuh"

namespace drone {

constexpr int N_UPSTATS = 8;
constexpr int UL = 32;       // samples of a tile
constexpr int US = UL + 1;   // row stride of the tile's activations: odd,
                             // so the outer products' column reads fall in
                             // distinct banks
// One block per SM of an H100. A constant, so the order of the sums never
// depends on the card.
constexpr int UPD_BLOCKS = 132;
// the block partial row: [W0 b0 W1 b1 | head W, head b, value W, value b |
// the 8 stats]
constexpr int BP_HEADS = OFF_WT;
constexpr int BP_STATS = BP_HEADS + (OFF_LS - OFF_HW);
constexpr int BP_W = BP_STATS + N_UPSTATS;
constexpr int GPT = CNN_H * (CNN_X2 + 1);  // a gemm partial row: [gWt | gbt]
constexpr int GT = 64;  // product tile (rows and columns)
constexpr int GK = 16;  // samples per product step

// shared floats of tile_kernel
constexpr int U_SP = 0;                        // splat scalars [12][US]
constexpr int U_XR = U_SP + 12 * US;           // 4 rendered patches [256][US]
constexpr int U_Y0 = U_XR + CNN_K1 * US;       // conv0 out, then dz0 [256][US]
constexpr int U_Y1 = U_Y0 + CNN_K1 * US;       // conv1 out, then dz1 [64][US]
constexpr int U_H = U_Y1 + CNN_C1 * US;        // h, then dzt [128][US]
constexpr int U_DMV = U_H + CNN_H * US;        // dm, g_v [5][US]
constexpr int U_GW0 = U_DMV + 5 * US;          // gW0 (64, 64)
constexpr int U_GB0 = U_GW0 + CNN_C0 * CNN_K0;
constexpr int U_GW1 = U_GB0 + CNN_C0;          // gW1 (64, 256)
constexpr int U_GB1 = U_GW1 + CNN_C1 * CNN_K1;
constexpr int U_GH = U_GB1 + CNN_C1;           // heads (5, 129)
constexpr int U_FLOATS = U_GH + 5 * (CNN_H + 1);

struct UpdArgs {
  const float* planes;  // (T, 21, n)
  const float* advret;  // (2, T, n)
  const int* perm;      // (n_sel,) row blocks of the minibatch
  const float* theta;   // flat parameters
  const float* wt;      // transposed weights (cnn.cuh T_*)
  const float* grid;    // pixel coordinates (2, 576)
  float* x2s;           // (tch, 576, NL) this chunk's trunk inputs
  float* dzs;           // (tch, 128, NL) this chunk's dzt
  float* bpart;         // (G, BP_W) this chunk's block partial rows
  int n, T, rbl, NL, tch, chunk, n_tiles;
};

__global__ void __launch_bounds__(CNN_THREADS, 1)
tile_kernel(UpdArgs A, UConsts co) {
  constexpr int L = UL, S = US;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sp = sm + U_SP;
  float* xr = sm + U_XR;
  float* y0 = sm + U_Y0;
  float* y1 = sm + U_Y1;
  float* hh = sm + U_H;
  float* dmv = sm + U_DMV;
  const int tid = threadIdx.x, n = A.n, NL = A.NL;
  for (int e = tid; e < U_FLOATS - U_GW0; e += blockDim.x) sm[U_GW0 + e] = 0.0f;
  float ls[4], stdv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ls[k] = A.theta[OFF_LS + k];
    stdv[k] = expf(ls[k]);
  }
  float stv[N_UPSTATS];
#pragma unroll
  for (int k = 0; k < N_UPSTATS; ++k) stv[k] = 0.0f;
  const int per_t = NL / L;

  for (int tau = blockIdx.x; tau < A.n_tiles; tau += gridDim.x) {
    const int tl = tau / per_t, ml0 = (tau % per_t) * L;
    const int t = A.chunk * A.tch + tl;
    const int lane0 = A.perm[ml0 / A.rbl] * A.rbl + ml0 % A.rbl;
    const float* pt = A.planes + (size_t)t * N_TRAJ * n + lane0;
    float* x2s = A.x2s + (size_t)tl * CNN_X2 * NL + ml0;
    float* dzs = A.dzs + (size_t)tl * CNN_H * NL + ml0;
    __syncthreads();  // the last tile's readers are done
    if (tid < L) {
      float o[OBS_DIM], s12[12];
#pragma unroll
      for (int k = 0; k < OBS_DIM; ++k) o[k] = pt[(size_t)(TP_OBS0 + k) * n + tid];
      splat12(o, s12);
#pragma unroll
      for (int k = 0; k < 12; ++k) sp[k * S + tid] = s12[k];
    }
    __syncthreads();

    // ---- forward ----------------------------------------------------------
    float tacc[TRUNK_ROWS<L>][4];
    zero_acc(tacc);
    for (int q1 = 0; q1 < CNN_NQ1; ++q1) {
      for (int k = 0; k < CNN_WIN; ++k)
        render_patch<L, S>(window_patch(q1, k), sp, A.grid, xr + k * CNN_K0 * S);
      __syncthreads();
      for (int k = 0; k < CNN_WIN; ++k)
        conv_relu<L, S>(A.wt + T_W0, CNN_K0, A.theta + OFF_B0,
                        xr + k * CNN_K0 * S, y0 + k * CNN_C0 * S);
      __syncthreads();
      window_conv1_trunk<L, S>(q1, A.theta, A.wt, y0, y1, tacc);
      for (int e = tid; e < CNN_C1 * L; e += blockDim.x) {
        const int o = e / L, l = e % L;
        x2s[(size_t)(q1 * CNN_C1 + o) * NL + l] = y1[o * S + l];
      }
      __syncthreads();
    }
    trunk_out<L, S>(A.theta, tacc, hh);
    __syncthreads();

    // ---- the heads and the PPO surrogate's gradients (K3's _head_grads) ---
    if (tid < L) {
      float m[4], v, a[4], dm[4], g_v, st[N_UPSTATS];
      cnn_heads(hh, S, tid, A.theta, m, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = pt[(size_t)(TP_ACT0 + k) * n + tid];
      const float* ar = A.advret + (size_t)t * n + lane0 + tid;
      head_grads(m, v, a, pt[(size_t)TP_LOGP * n + tid],
                 pt[(size_t)TP_VAL * n + tid], ar[0], ar[(size_t)A.T * n], ls,
                 stdv, co, dm, g_v, st);
#pragma unroll
      for (int k = 0; k < N_UPSTATS; ++k) stv[k] = stv[k] + st[k];
#pragma unroll
      for (int k = 0; k < 4; ++k) dmv[k * S + tid] = dm[k];
      dmv[4 * S + tid] = g_v;
    }
    __syncthreads();
    // the heads' gradients: [dm; g_v] h^T and their sums
    float* gh = sm + U_GH;
    for (int e = tid; e < 5 * (CNN_H + 1); e += blockDim.x) {
      const int r = e / (CNN_H + 1), u = e % (CNN_H + 1);
      float s = 0.0f;
      if (u < CNN_H) {
        for (int l = 0; l < L; ++l) s = __fmaf_rn(dmv[r * S + l], hh[u * S + l], s);
      } else {
        for (int l = 0; l < L; ++l) s = s + dmv[r * S + l];
      }
      gh[e] = gh[e] + s;
    }
    __syncthreads();
    // dzt = (Hw^T dm + Vw^T g_v) * (h > 0), over h in place and to the scratch
    for (int e = tid; e < CNN_H * L; e += blockDim.x) {
      const int u = e / L, l = e % L;
      float d = __ldg(A.theta + OFF_HW + u) * dmv[l];
#pragma unroll
      for (int k = 1; k < 4; ++k)
        d = __fmaf_rn(__ldg(A.theta + OFF_HW + k * CNN_H + u), dmv[k * S + l], d);
      d = d + __ldg(A.theta + OFF_VW + u) * dmv[4 * S + l];
      const float dz = d * (hh[u * S + l] > 0.0f ? 1.0f : 0.0f);
      hh[u * S + l] = dz;
      dzs[(size_t)u * NL + l] = dz;
    }
    __syncthreads();

    // ---- the encoder's backward, window by window ---------------------------
    cnn_tile_bwd<L, S>(sp, A.theta, A.wt, A.grid, hh, x2s, NL, xr, y0, y1,
                       sm + U_GW0);
  }

  // this block's partial row
  float* part = A.bpart + (size_t)blockIdx.x * BP_W;
  for (int e = tid; e < OFF_WT; e += blockDim.x) part[e] = sm[U_GW0 + e];
  for (int e = tid; e < 5 * (CNN_H + 1); e += blockDim.x) {
    const int r = e / (CNN_H + 1), u = e % (CNN_H + 1);
    const float g = sm[U_GH + e];
    if (r < 4)
      part[BP_HEADS + (u < CNN_H ? r * CNN_H + u : 4 * CNN_H + r)] = g;
    else
      part[BP_HEADS + (OFF_VW - OFF_HW) + u] = g;  // value W then value b
  }
  __syncthreads();
  float* red = sm;  // the lanes' stat sums, summed in lane order
  if (tid < L)
#pragma unroll
    for (int k = 0; k < N_UPSTATS; ++k) red[k * L + tid] = stv[k];
  __syncthreads();
  if (tid < N_UPSTATS) {
    float s = 0.0f;
    for (int l = 0; l < L; ++l) s = s + red[tid * L + l];
    part[BP_STATS + tid] = s;
  }
}

// K7's split-K product (update_lstm.cu): C (M x N) = sum_s A[m][s] B[n][s]
// with the bias sums sum_s A[m][s] as column N, over the chunk's samples
// (s = t * NL + lane); block (i, j, kc) takes the 64 x 64 tile (i, j) over
// CK lanes of one step and writes its own partial row (row0 + kc).
struct GemmPair {
  const float* a;
  int ra, M;
  const float* b;
  int rb, N;
};

__global__ void __launch_bounds__(256)
cnn_gemm_kernel(GemmPair p, int NL, int CK, float* __restrict__ partial,
                 int ptot, int row0) {
  __shared__ __align__(16) float As[2][GK][GT + 4];
  __shared__ __align__(16) float Bs[2][GK][GT + 4];
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  const int m0 = blockIdx.x * GT, n0 = blockIdx.y * GT, kc = blockIdx.z;
  const int per_t = NL / CK;
  const int t = kc / per_t, lane0 = (kc % per_t) * CK;
  const float* a = p.a + (size_t)t * p.ra * NL + lane0;
  const float* b = p.b + (size_t)t * p.rb * NL + lane0;
  const bool bias = blockIdx.y == 0 && tn == 0;
  float acc[4][4], bsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bsum[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  const int li = tid / 4, lk = 4 * (tid % 4);
  const bool a_ok = m0 + li < p.M, b_ok = n0 + li < p.N;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4* pa = reinterpret_cast<const float4*>(a + (size_t)(m0 + li) * NL + lk);
  const float4* pb = reinterpret_cast<const float4*>(b + (size_t)(n0 + li) * NL + lk);
  float4 ra = a_ok ? __ldg(pa) : zero4, rb = b_ok ? __ldg(pb) : zero4;
  int buf = 0;
  for (int k0 = 0; k0 < CK; k0 += GK) {
    As[buf][lk + 0][li] = ra.x;
    As[buf][lk + 1][li] = ra.y;
    As[buf][lk + 2][li] = ra.z;
    As[buf][lk + 3][li] = ra.w;
    Bs[buf][lk + 0][li] = rb.x;
    Bs[buf][lk + 1][li] = rb.y;
    Bs[buf][lk + 2][li] = rb.z;
    Bs[buf][lk + 3][li] = rb.w;
    __syncthreads();
    if (k0 + GK < CK) {
      ra = a_ok ? __ldg(pa + (k0 + GK) / 4) : zero4;
      rb = b_ok ? __ldg(pb + (k0 + GK) / 4) : zero4;
    }
#pragma unroll
    for (int kk = 0; kk < GK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[buf][kk][4 * tm]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[buf][kk][4 * tn]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(ar[i], br[j], acc[i][j]);
        if (bias) bsum[i] = bsum[i] + ar[i];
      }
    }
    buf ^= 1;
  }
  float* out = partial + (size_t)(row0 + kc) * ptot;
  const int W = p.N + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * tm + i;
    if (m >= p.M) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + 4 * tn + j;
      if (c < p.N) out[(size_t)m * W + c] = acc[i][j];
    }
    if (bias) out[(size_t)m * W + p.N] = bsum[i];
  }
}

// grads[q] for every flat parameter q and the 8 stat sums: the sum, in
// row order, over the RG gemm rows (Wt, bt) or the RB block rows (the
// rest); log_std's gradient is its stat sums minus ent_coef.
__global__ void cnn_reduce_kernel(const float* __restrict__ gpart, int RG,
                                  const float* __restrict__ bpart, int RB,
                                  float ent_coef, float* __restrict__ grads,
                                  float* __restrict__ stats) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= CNN_P + N_UPSTATS) return;
  float s = 0.0f;
  if (q >= OFF_WT && q < OFF_HW) {
    const int j = q - OFF_WT;
    const int e = q < OFF_BT ? (j / CNN_X2) * (CNN_X2 + 1) + j % CNN_X2
                             : (q - OFF_BT) * (CNN_X2 + 1) + CNN_X2;
    for (int r = 0; r < RG; ++r) s = s + gpart[(size_t)r * GPT + e];
    grads[q] = s;
    return;
  }
  int e;
  if (q >= CNN_P) e = BP_STATS + (q - CNN_P);
  else if (q >= OFF_LS) e = BP_STATS + 4 + (q - OFF_LS);
  else if (q >= OFF_HW) e = BP_HEADS + (q - OFF_HW);
  else e = q;
  for (int r = 0; r < RB; ++r) s = s + bpart[(size_t)r * BP_W + e];
  if (q >= CNN_P)
    stats[q - CNN_P] = s;
  else
    grads[q] = q >= OFF_LS ? s - ent_coef : s;
}

}  // namespace drone

// C interface (ctypes). ptrs: host array of device pointers [planes,
// advret, perm, theta, wt, grid, x2s, dzs, bpart, gpart, grads, stats]; the
// scratch x2s (tch, 576, NL) and dzs (tch, 128, NL), the partial rows bpart
// (n_chunks * G, BP_W) and gpart (n_chunks * tch * NL / CK, 128 * 577).
// dims: [n, T, rbl, NL, tch, CK, G]. consts: [inv_m, clip_lo, clip_hi,
// clip_eps, vf_clip, half_vf_coef, ent_coef]. Returns the cudaError_t of
// the launches.
extern "C" int drone_cnn_update(const uint64_t* ptrs, const int* dims,
                                const float* consts, void* stream) {
  using namespace drone;
  const int n = dims[0], T = dims[1], rbl = dims[2], NL = dims[3];
  const int tch = dims[4], CK = dims[5], G = dims[6];
  if (n <= 0 || T <= 0 || tch <= 0 || T % tch != 0 || rbl % 128 != 0 ||
      NL % rbl != 0 || NL % UL != 0 || CK % GK != 0 || NL % CK != 0 ||
      G <= 0 || G > UPD_BLOCKS)
    return (int)cudaErrorInvalidValue;
  const float** ptr = reinterpret_cast<const float**>(const_cast<uint64_t*>(ptrs));
  UpdArgs A;
  A.planes = ptr[0];
  A.advret = ptr[1];
  A.perm = reinterpret_cast<const int*>(ptr[2]);
  A.theta = ptr[3];
  A.wt = ptr[4];
  A.grid = ptr[5];
  A.x2s = const_cast<float*>(ptr[6]);
  A.dzs = const_cast<float*>(ptr[7]);
  float* bpart = const_cast<float*>(ptr[8]);
  float* gpart = const_cast<float*>(ptr[9]);
  float* grads = const_cast<float*>(ptr[10]);
  float* stats = const_cast<float*>(ptr[11]);
  A.n = n;
  A.T = T;
  A.rbl = rbl;
  A.NL = NL;
  A.tch = tch;
  A.n_tiles = tch * (NL / UL);
  if (G > A.n_tiles) return (int)cudaErrorInvalidValue;
  const UConsts co{consts[0], consts[1], consts[2], consts[3],
                   consts[4], consts[5], consts[6]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * (size_t)U_FLOATS;
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = T / tch, nk = tch * (NL / CK);
  const GemmPair gp{A.dzs, CNN_H, CNN_H, A.x2s, CNN_X2, CNN_X2};
  const dim3 grid((CNN_H + GT - 1) / GT, (CNN_X2 + GT - 1) / GT, nk);
  for (int c = 0; c < n_chunks; ++c) {
    A.chunk = c;
    A.bpart = bpart + (size_t)c * G * BP_W;
    tile_kernel<<<G, CNN_THREADS, smem, s>>>(A, co);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    cnn_gemm_kernel<<<grid, 256, 0, s>>>(gp, NL, CK, gpart, GPT, c * nk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cnn_reduce_kernel<<<(CNN_P + N_UPSTATS + 255) / 256, 256, 0, s>>>(
      gpart, n_chunks * nk, bpart, n_chunks * G, co.ent_coef, grads, stats);
  return (int)cudaGetLastError();
}
