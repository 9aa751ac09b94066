// update_lstm.cu — the truncated-BPTT PPO update (K7): one minibatch of the
// LSTM policy's forward and hand-written backward through time, its
// gradients and the 8 stat sums.
//
// Replaces drone_tpu/ops/pallas_update_lstm.py `_lstm_update_kernel`
// (driven by `ppo_lstm_update`). Wrapper and plain version:
// ops/cuda_update_lstm.py.
//
// Three kernels, launched for each bptt segment of the minibatch in turn:
//   bptt_kernel: a block of 256 threads owns 64 lanes of the minibatch. It
//     runs the segment forward from its (c, h) anchor (lstm.cuh: encoder,
//     gate block), storing each step's activations in a device scratch, then
//     walks the steps backward: the PPO head's gradients per lane
//     (policy.cuh head_grads, K3's), dh' and dc' through the cell, the gate
//     pre-activation gradients dz (4H per sample, written over the stored
//     gates), dx and the next dh from one register-tiled product with the
//     packed gate weights, and the encoder's dpre. The gradient entering
//     step t through time is masked by step t's keep; it stops at the
//     anchor (truncation). Each block sums its lanes' 8 stats in a fixed
//     order into its own row.
//   grad_gemm_kernel: the weight gradients as products over the segment's
//     samples, dW = sum_s A[:, s] B[:, s]^T with the bias sums beside them
//     (dz x [x; h_in] for the gates, [dm; g_v] x h' for the heads, dpre x
//     the layer input for the encoder). The samples are split in fixed
//     chunks; each (tile, chunk) block writes its own partial row.
//   reduce_kernel: adds the partial rows of every segment and chunk in a
//     fixed order into the flat gradient, and the stat rows into the 8 sums
//     (log_std's gradient is its stat sums minus ent_coef).
// No float atomics: two launches on the same inputs give the same bits, so
// training on the card is deterministic and a resume repeats a run.
//
// The reference re-runs the forward from chunk-boundary carries because a
// segment's activations overflow VMEM; here they fit in device memory
// (~1.2 GB per segment at 16,384 lanes x 16 steps, H 128, E 64), so one
// forward per step is run, not 1 + 1.375.
//
// What bounds it on an H100: per sample about 298.5k multiply-adds at H
// 128 / E 64 (forward 98k, dx and dh 98k, the weight products 98k), on the
// fp32 cores; the bytes (planes, anchors, the scratch's traffic) are far
// below the memory rate's share. The gate weights stream from L2.
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
//     gradient at the trunk's pre-activation, to the scratch. Its forward
//     needs E + 2H rows, its backward 6H + E + 6 = 902 rows of 64 lanes
//     (230,912 bytes at H 128), so it stays one block an SM;
//   tower_bwd_kernel (cnn_mma.cuh, K10's): the tower's backward on the
//     tensor cores (the patches re-rendered from the stored obs, conv0
//     re-run, gW0 and gW1 in a block's registers over fixed 64-sample
//     tiles), its block rows written into the product rows' first OFF_WT
//     columns;
//   the product pairs, gWt and gbt among them (dzt x X2, fp32).
// Per sample the arm adds ~1.1 M multiply-adds to the LSTM's 2 x 131k: the
// forward tower 369k, conv0 again 147k, dX2 74k, gW1 147k, dX1 147k, gW0
// 147k on the tensor cores, gWt 74k on the fp32 cores; one segment's
// scratch is ~1.9 GB at 16,384 lanes x 16 steps, H 128.

#include <cuda_runtime.h>

#include <cstdint>

#include "cnn_mma.cuh"
#include "lstm.cuh"

namespace drone {

constexpr int N_UPSTATS = 8;
constexpr int BP_LANES = 64;
constexpr int BP_PASSES = (LSTM_MAX_H / 4) * (BP_LANES / 4) / LSTM_THREADS;
// the gate block's and the backward product's loops over weight rows keep 8
// rows of loads in flight (233 registers, no spill)
constexpr int BP_UNROLL = 8;
constexpr int GT = 64;  // product tile (rows and columns)
constexpr int GK = 16;  // samples per product step
// scratch buffers, each (bptt, rows, NL): X2S only in the CNN arm, DP the
// dense encoder's dpre or the CNN arm's dzt
enum { XS = 0, GZ = 1, CT = 2, H2S = 3, DMV = 4, DP = 5, N_SCRATCH = 6,
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
  const float4* WP;     // (E + H, H, 4)
  const float4* BP;     // (H, 4)
  float* s[N_SCRATCH];  // each (bptt, rows, NL)
  float* stat_part;     // (blocks, 8) of this segment
  int n, T, bptt, seg, rbl, NL;
};

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// out[r] = sum_j W[j][r] d[j] over a tile (W (nout, nin) row-major, r <
// nin, rows of LANES floats): the input gradient of a dense layer.
template <int LANES>
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
      const float4 x = *reinterpret_cast<const float4*>(d + j * LANES + l0);
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
      store4(out + (r0 + i) * LANES + l0, acc[i]);
    }
  }
}

__host__ __device__ inline int bptt_smem_floats(const LstmNet& net,
                                                int encoder) {
  int maxw, nbuf;
  enc_buffers(net, maxw, nbuf);
  int maxe = 0;
  for (int i = 0; i < net.n_enc; ++i) maxe = net.enc_w[i] > maxe ? net.enc_w[i] : maxe;
  int fwd = OBS_DIM + nbuf * maxw + net.E + 2 * net.H;
  if (encoder == ENC_CNN) {
    fwd = net.E + 2 * net.H;
    maxe = net.E;
  }
  const int bwd = 6 * net.H + maxe + 6;
  return BP_LANES * (fwd > bwd ? fwd : bwd);
}

template <int ENC>
__global__ void __launch_bounds__(LSTM_THREADS, 1)
bptt_kernel(BpttArgs A, LstmNet net, UConsts co) {
  constexpr bool CNN = ENC == ENC_CNN;
  constexpr int L = BP_LANES;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int H = net.H, E = net.E, n = A.n, NL = A.NL, tid = threadIdx.x;
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
  // dense: the obs rows and the encoder's buffers before xh; CNN: xh alone
  // (tower_fwd_kernel wrote x to the scratch)
  float *obs, *buf0, *buf1, *xh;
  if constexpr (CNN) {
    obs = buf0 = buf1 = nullptr;
    xh = sm;
  } else {
    int maxw, nbuf;
    enc_buffers(net, maxw, nbuf);
    obs = sm;
    buf0 = obs + OBS_DIM * L;
    buf1 = buf0 + maxw * L;
    xh = buf0 + nbuf * maxw * L;
  }
  float* h = xh + E * L;
  float* c = xh + (E + H) * L;
  float* obs_rows = net.n_enc ? obs : xh;
  const float* anc = A.snap + (size_t)A.seg * 2 * H * n + lane0;
  for (int e = tid; e < H * L; e += blockDim.x) {
    const int u = e / L, l = e % L;
    c[u * L + l] = anc[(size_t)u * n + l];
    h[u * L + l] = anc[(size_t)(H + u) * n + l];
  }
  __syncthreads();
  for (int t = 0; t < A.bptt; ++t) {
    const float* pt = A.planes + (size_t)(A.seg * A.bptt + t) * N_TRAJ * n + lane0;
    float* xs = A.s[XS] + (size_t)t * RX * NL + ml0;
    if constexpr (CNN) {
      // x, the tower's output, from the scratch
      for (int e = tid; e < E * L; e += blockDim.x) {
        const int k = e / L, l = e % L;
        xh[k * L + l] = xs[(size_t)(OBS_DIM + k) * NL + l];
      }
    } else {
      for (int e = tid; e < OBS_DIM * L; e += blockDim.x) {
        const int k = e / L, l = e % L;
        const float v = pt[(size_t)(TP_OBS0 + k) * n + l];
        obs_rows[k * L + l] = v;
        xs[(size_t)k * NL + l] = v;
      }
    }
    for (int e = tid; e < H * L; e += blockDim.x) {
      const int u = e / L, l = e % L;
      xs[(size_t)(h_row + u) * NL + l] = h[u * L + l];
    }
    __syncthreads();
    if constexpr (!CNN) {
      lstm_encoder<L>(obs, buf0, buf1, xh, A.theta, net,
                      [&](int i, const float* out) {
                        int r0 = OBS_DIM;
                        for (int j = 0; j < i; ++j) r0 += net.enc_w[j];
                        for (int e = tid; e < net.enc_w[i] * L;
                             e += blockDim.x) {
                          const int k = e / L, l = e % L;
                          xs[(size_t)(r0 + k) * NL + l] = out[k * L + l];
                        }
                      });
    }
    float* gs = A.s[GZ] + (size_t)t * 4 * H * NL + ml0;
    float* cts = A.s[CT] + (size_t)t * 2 * H * NL + ml0;
    float* h2s = A.s[H2S] + (size_t)t * H * NL + ml0;
    lstm_gates<L, BP_PASSES, BP_UNROLL>(
        xh, c, E, H, A.WP, A.BP,
        [&](int u, int l0, const float* gi, const float* gf, const float* gg,
            const float* go, const float* cin, const float* th,
            const float* h2) {
          store4(gs + (size_t)u * NL + l0, gi);
          store4(gs + (size_t)(H + u) * NL + l0, gf);
          store4(gs + (size_t)(2 * H + u) * NL + l0, gg);
          store4(gs + (size_t)(3 * H + u) * NL + l0, go);
          store4(cts + (size_t)u * NL + l0, cin);
          store4(cts + (size_t)(H + u) * NL + l0, th);
          store4(h2s + (size_t)u * NL + l0, h2);
        });
    __syncthreads();
    // _mask_carry with the step's stored done
    for (int e = tid; e < H * L; e += blockDim.x) {
      const int u = e / L, l = e % L;
      const float keep = 1.0f - pt[(size_t)TP_DONE * n + l];
      c[u * L + l] = c[u * L + l] * keep;
      h[u * L + l] = h[u * L + l] * keep;
    }
    __syncthreads();
  }

  // ---- backward through time ---------------------------------------------
  int maxe = 0;
  for (int i = 0; i < net.n_enc; ++i) maxe = net.enc_w[i] > maxe ? net.enc_w[i] : maxe;
  if constexpr (CNN) maxe = E;
  float* dh = sm;
  float* dc = dh + H * L;
  float* dz = dc + H * L;
  float* dx = dz + 4 * H * L;
  float* dmv = dx + maxe * L;
  float* keep_s = dmv + 5 * L;
  for (int e = tid; e < H * L; e += blockDim.x) {
    dh[e] = 0.0f;
    dc[e] = 0.0f;
  }
  float stv[N_UPSTATS];
#pragma unroll
  for (int k = 0; k < N_UPSTATS; ++k) stv[k] = 0.0f;
  const float* hw = A.theta + net.head_off;
  const float* vw = A.theta + net.vhead_off;
  // no encoder: x is data, no dx
  const int r_lo = CNN || net.n_enc ? 0 : E;
  for (int t = A.bptt - 1; t >= 0; --t) {
    const int ts = A.seg * A.bptt + t;
    const float* pt = A.planes + (size_t)ts * N_TRAJ * n + lane0;
    const float* xs = A.s[XS] + (size_t)t * RX * NL + ml0;
    float* gs = A.s[GZ] + (size_t)t * 4 * H * NL + ml0;
    const float* cts = A.s[CT] + (size_t)t * 2 * H * NL + ml0;
    if (tid < L) {
      // the heads and the PPO surrogate's gradients (K3's _head_grads)
      float m[4], v, a[4], dm[4], g_v, st[N_UPSTATS];
      lstm_heads(A.s[H2S] + (size_t)t * H * NL + ml0, NL, tid, A.theta, net,
                 m, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) a[k] = pt[(size_t)(TP_ACT0 + k) * n + tid];
      const float* ar = A.advret + (size_t)ts * n + lane0 + tid;
      head_grads(m, v, a, pt[(size_t)TP_LOGP * n + tid],
                 pt[(size_t)TP_VAL * n + tid], ar[0],
                 ar[(size_t)A.T * n], ls, stdv, co, dm, g_v, st);
#pragma unroll
      for (int k = 0; k < N_UPSTATS; ++k) stv[k] = stv[k] + st[k];
      float* dmvs = A.s[DMV] + (size_t)t * 5 * NL + ml0 + tid;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        dmv[k * L + tid] = dm[k];
        dmvs[(size_t)k * NL] = dm[k];
      }
      dmv[4 * L + tid] = g_v;
      dmvs[(size_t)4 * NL] = g_v;
      keep_s[tid] = 1.0f - pt[(size_t)TP_DONE * n + tid];
    }
    __syncthreads();
    // through the cell: dh', dc', dz; dc for the step before
    for (int e = tid; e < H * L; e += blockDim.x) {
      const int u = e / L, l = e % L;
      const float keep = keep_s[l];
      float hd = __ldg(hw + u) * dmv[l];
#pragma unroll
      for (int k = 1; k < 4; ++k) hd = __fmaf_rn(__ldg(hw + k * H + u), dmv[k * L + l], hd);
      const float dh2 = (hd + __ldg(vw + u) * dmv[4 * L + l]) + dh[e] * keep;
      const size_t gu = (size_t)u * NL + l;
      const float gi = gs[gu], gf = gs[gu + (size_t)H * NL];
      const float gg = gs[gu + (size_t)2 * H * NL], go = gs[gu + (size_t)3 * H * NL];
      const float cin = cts[gu], th = cts[gu + (size_t)H * NL];
      const float dc2 = dc[e] * keep + dh2 * go * (1.0f - th * th);
      const float dgo = dh2 * th;
      const float dgi = dc2 * gg;
      const float dgf = dc2 * cin;
      const float dgg = dc2 * gi;
      dc[e] = dc2 * gf;
      const float z[4] = {dgi * (gi * (1.0f - gi)), dgf * (gf * (1.0f - gf)),
                          dgg * (1.0f - gg * gg), dgo * (go * (1.0f - go))};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dz[(g * H + u) * L + l] = z[g];
        gs[gu + (size_t)g * H * NL] = z[g];
      }
    }
    __syncthreads();
    // [dx; dh] = sum over units u and gates g of WP[r][u][g] dz[g][u]
    {
      constexpr int LB = L / 4;
      const int rows = E + H - r_lo;
      const int tiles = ((rows + 3) / 4) * LB;
      for (int tile = tid; tile < tiles; tile += blockDim.x) {
        const int r0 = r_lo + 4 * (tile / LB), l0 = 4 * (tile % LB);
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;
#pragma unroll (BP_UNROLL)
        for (int u = 0; u < H; ++u) {
          float4 zg[4];
#pragma unroll
          for (int g = 0; g < 4; ++g)
            zg[g] = *reinterpret_cast<const float4*>(dz + (g * H + u) * L + l0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 w = r0 + i < E + H ? __ldg(A.WP + (size_t)(r0 + i) * H + u)
                                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            const float wg[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int g = 0; g < 4; ++g) {
              acc[i][0] = __fmaf_rn(wg[g], zg[g].x, acc[i][0]);
              acc[i][1] = __fmaf_rn(wg[g], zg[g].y, acc[i][1]);
              acc[i][2] = __fmaf_rn(wg[g], zg[g].z, acc[i][2]);
              acc[i][3] = __fmaf_rn(wg[g], zg[g].w, acc[i][3]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + i;
          if (r >= E + H) break;
          store4(r < E ? dx + r * L + l0 : dh + (r - E) * L + l0, acc[i]);
        }
      }
    }
    __syncthreads();
    if constexpr (CNN) {
      // the trunk's relu: dzt = dx * (x > 0) to the scratch; the conv
      // backward runs after the segment (tower_bwd_kernel)
      float* dzs = A.s[DP] + (size_t)t * E * NL + ml0;
      for (int e = tid; e < E * L; e += blockDim.x) {
        const int k = e / L, l = e % L;
        const float x = xs[(size_t)(OBS_DIM + k) * NL + l];
        dzs[(size_t)k * NL + l] = dx[e] * (x > 0.0f ? 1.0f : 0.0f);
      }
      continue;
    }
    // the encoder backward: dpre = dx (1 - y^2), then dx of the layer below
    float* d = dx;
    for (int i = net.n_enc - 1; i >= 0; --i) {
      int r0 = 0;
      for (int j = 0; j < i; ++j) r0 += net.enc_w[j];
      float* dps = A.s[DP] + ((size_t)t * net.enc_rows + r0) * NL + ml0;
      for (int e = tid; e < net.enc_w[i] * L; e += blockDim.x) {
        const int k = e / L, l = e % L;
        const float y = xs[(size_t)(OBS_DIM + r0 + k) * NL + l];
        const float dp = d[e] * (1.0f - y * y);
        d[e] = dp;
        dps[(size_t)k * NL + l] = dp;
      }
      __syncthreads();
      if (i > 0) {
        float* d2 = d == dx ? dz : dx;  // dz is free once the product ran
        dense_t<L>(A.theta + net.enc_off[i], net.enc_w[i], net.enc_w[i - 1],
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

__global__ void __launch_bounds__(TM_THREADS, 2)
tower_fwd_kernel(TowerFwdArgs A) {
  constexpr int L = TM_L, S = TM_S;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* sp = tf_rows(sm) + TF_SP * S;
  const float* hh = tf_rows(sm) + TF_Y0 * S;
  const int tid = threadIdx.x, n = A.n, NL = A.NL, per_t = NL / L;
  tower_load_w0(sm, A.pk);  // before the first tile's barriers
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
    tower_fwd_tile(sm, A.theta, A.pk, A.grid, [&](int q1, const float* y1) {
      for (int e = tid; e < CNN_C1 * L; e += blockDim.x) {
        const int o = e / L, l = e % L;
        x2s[(size_t)(q1 * CNN_C1 + o) * NL + l] = y1[o * S + l];
      }
    });
    __syncthreads();
    for (int e = tid; e < CNN_H * L; e += blockDim.x) {
      const int k = e / L, l = e % L;
      xs[(size_t)(OBS_DIM + k) * NL + l] = hh[k * S + l];
    }
  }
}

// One product of the weight gradients over a segment's samples: C (M x N)
// = sum_s A[m][s] B[n][s], and with blockIdx.y == 0 the bias sums sum_s
// A[m][s] as column N. A and B are scratch buffers (bptt, rows, NL) from
// rows a0 / b0; sample s = t * NL + lane. Block (i, j, kc) takes the 64 x
// 64 tile (i, j) over chunk kc of CK lanes of one step and writes its own
// partial row (row0 + kc) of the (rows, ptot) buffer at out_off, the block
// (M, N + 1) row-major.
struct GemmPair {
  const float* a;
  int ra, a0, M;
  const float* b;
  int rb, b0, N;
  int out_off;
};

__global__ void __launch_bounds__(256)
grad_gemm_kernel(GemmPair p, int NL, int CK, float* __restrict__ partial,
                 int ptot, int row0) {
  // A thread owns 4 rows x 4 columns of the 64 x 64 tile. The tiles are
  // double-buffered in shared memory: each thread loads its float4 of A and
  // of B for the next step while the block computes this one, so one
  // barrier a step.
  __shared__ __align__(16) float As[2][GK][GT + 4];
  __shared__ __align__(16) float Bs[2][GK][GT + 4];
  const int tid = threadIdx.x, tm = tid / 16, tn = tid % 16;
  const int m0 = blockIdx.x * GT, n0 = blockIdx.y * GT, kc = blockIdx.z;
  const int per_t = NL / CK;
  const int t = kc / per_t, lane0 = (kc % per_t) * CK;
  const float* a = p.a + ((size_t)t * p.ra + p.a0) * NL + lane0;
  const float* b = p.b + ((size_t)t * p.rb + p.b0) * NL + lane0;
  const bool bias = blockIdx.y == 0 && tn == 0;
  float acc[4][4], bsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    bsum[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }
  // this thread's row (li) and 4 samples (lk ..) of each step's tiles
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
    buf ^= 1;  // the other buffer's last readers passed this step's barrier
  }
  float* out = partial + (size_t)(row0 + kc) * ptot + p.out_off;
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
// advret, snap, perm, theta, wp, bp, the 7 scratch buffers (XS, GZ, CT, H2,
// DMV, DP, X2S), partial, stat_part, map, grads, stats, pk, grid]; X2S, the
// packed tower weights pk (PK_TOTAL float4s) and grid are the CNN arm's
// (null for the dense one). layout: lstm.cuh's NET_INTS; encoder: ENC_DENSE
// or ENC_CNN. dims: [n, T, bptt, rbl, NL, CK, P, ptot, n_pairs, the 7
// scratch row counts, the walk's shared bytes as the wrapper counts them,
// and for the CNN arm the tower's forward and backward ones]. pairs:
// n_pairs x [A buffer,
// A row0, M, B buffer, B row0, N, out offset]. consts: [inv_m, clip_lo,
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
  const bool cnn = encoder == ENC_CNN;
  const size_t smem = sizeof(float) * (size_t)bptt_smem_floats(net, encoder);
  if (n <= 0 || bptt <= 0 || T % bptt != 0 || rbl % 128 != 0 ||
      NL % BP_LANES != 0 || CK % GK != 0 || NL % CK != 0 || n_pairs <= 0 ||
      smem_bytes[0] != (int)smem ||
      (cnn && (NL % TM_L != 0 || ptot < OFF_WT ||
               rows[XS] != OBS_DIM + CNN_H + net.H || rows[DP] != CNN_H ||
               rows[X2S] != CNN_X2 || smem_bytes[1] != TF_SMEM ||
               smem_bytes[2] != TB_SMEM)))
    return (int)cudaErrorInvalidValue;
  const float** ptr = reinterpret_cast<const float**>(const_cast<uint64_t*>(ptrs));
  BpttArgs A;
  A.planes = ptr[0];
  A.advret = ptr[1];
  A.snap = ptr[2];
  A.perm = reinterpret_cast<const int*>(ptr[3]);
  A.theta = ptr[4];
  A.WP = reinterpret_cast<const float4*>(ptr[5]);
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
  if (cnn && (pk == nullptr || grid == nullptr || bufs[X2S] == nullptr))
    return (int)cudaErrorInvalidValue;
  A.n = n;
  A.T = T;
  A.bptt = bptt;
  A.rbl = rbl;
  A.NL = NL;
  const UConsts co{consts[0], consts[1], consts[2], consts[3],
                   consts[4], consts[5], consts[6]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* walk = cnn ? bptt_kernel<ENC_CNN> : bptt_kernel<ENC_DENSE>;
  cudaError_t err = cudaFuncSetAttribute(
      walk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int S = T / bptt, nblk = NL / BP_LANES, nk = bptt * (NL / CK);
  const int n_tiles = bptt * (NL / TM_L);
  TowerFwdArgs tf{A.planes, A.perm, A.theta, pk, grid, bufs[XS], bufs[X2S],
                  n, rbl, 0, rows[XS], NL, n_tiles};
  TowerBwdArgs tb{bufs[XS], (size_t)rows[XS] * NL, NL, nullptr, rbl, 0,
                  bufs[DP], bufs[X2S], A.theta, pk, grid, partial, ptot, 0,
                  NL, n_tiles};
  const int tf_blocks = n_tiles < TOWER_FWD_BLOCKS ? n_tiles : TOWER_FWD_BLOCKS;
  if (cnn) {
    err = cudaFuncSetAttribute(tower_fwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TF_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(tower_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TB_SMEM);
    if (err != cudaSuccess) return (int)err;
    pack_tower_kernel<<<(PK_TOTAL + 255) / 256, 256, 0, s>>>(A.theta, pk,
                                                             PK_TOTAL);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  for (int seg = 0; seg < S; ++seg) {
    A.seg = seg;
    A.stat_part = stat_part + (size_t)seg * nblk * N_UPSTATS;
    if (cnn) {
      tf.t0 = seg * bptt;
      tower_fwd_kernel<<<tf_blocks, TM_THREADS, TF_SMEM, s>>>(tf);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    walk<<<nblk, LSTM_THREADS, smem, s>>>(A, net, co);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (cnn) {
      // one block per product row of the segment (nk <= the tiles)
      tb.row0 = seg * nk;
      tower_bwd_kernel<<<nk, TM_THREADS, TB_SMEM, s>>>(tb);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    for (int q = 0; q < n_pairs; ++q) {
      const int* d = pairs + 7 * q;
      const GemmPair gp{bufs[d[0]], rows[d[0]], d[1], d[2],
                        bufs[d[3]], rows[d[3]], d[4], d[5], d[6]};
      const dim3 grid((gp.M + GT - 1) / GT, (gp.N + GT - 1) / GT, nk);
      grad_gemm_kernel<<<grid, 256, 0, s>>>(gp, NL, CK, partial, ptot, seg * nk);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  lstm_reduce_kernel<<<(P + N_UPSTATS + 255) / 256, 256, 0, s>>>(
      partial, S * nk, ptot, map, P, stat_part, S * nblk, co.ent_coef, grads,
      stats);
  return (int)cudaGetLastError();
}
