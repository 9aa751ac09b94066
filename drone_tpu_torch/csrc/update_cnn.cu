// update_cnn.cu — the CNN PPO update (K10): one minibatch of the patch-CNN
// policy's forward and hand-written backward, its gradients and the 8 stat
// sums.
//
// Replaces drone_tpu/ops/pallas_update_cnn.py `_cnn_update_kernel` (driven
// by `ppo_cnn_update`). Wrapper and plain version: ops/cuda_update_cnn.py.
//
// The pixels are never stored, in either direction: each tile re-renders
// its conv0 patches from the stored obs planes, as the reference does. The
// tower's products run on the tensor cores in 3xTF32 (cnn_mma.cuh). The
// minibatch's steps go in chunks (the scratch of one chunk is ~0.7 GB at
// 16,384 lanes x 16 steps); pack_tower_kernel first splits the weights
// into their (big, small) fragments, then per chunk three kernels run:
//   cnn_fwd_kernel: a block of 256 threads (two an SM) takes fixed tiles of
//     64 samples (64 lanes of one row block at one step). Per tile the
//     tower's forward (cnn_mma.cuh tower_fwd_tile, the acting kernels'
//     too; W0's fragments in shared memory), storing each window's
//     conv1 output (the trunk's input X2) in a device scratch; the heads and
//     the PPO head's gradients per sample (policy.cuh head_grads, K3's); the
//     heads' gradient sums in registers (each entry always the same
//     thread's); dzt = dh * (h > 0) to the scratch. Each block writes its
//     heads' gradients and its 8 stat sums to its own partial row.
//   tower_bwd_kernel (cnn_mma.cuh, shared with K7's CNN arm): per tile of
//     64 samples, window by window, the patches re-rendered and conv0
//     re-run, dX2 = dzt Wt masked by conv1's relu (dz1), gW1 += dz1 X1^T,
//     dX1 = dz1 W1 masked by conv0's relu (dz0), gW0 += dz0 X0^T; gW0 and
//     gW1 stay in the block's registers over its tiles, then go to its own
//     partial row.
//   cnn_gemm_kernel (K7's product, fp32 CUDA cores): gWt and gbt as a
//     split-K product of the scratch's dzt (128 rows) and X2 (576 rows) over
//     the chunk's samples, each (tile, chunk) block writing its own partial
//     row.
// A last kernel adds the partial rows in a fixed order. No float atomics:
// two launches on the same inputs give the same bits, so training on the
// card is deterministic and a resume repeats a run (H6).
//
// The bf16 arm (compute_dtype="bfloat16", the reference's bf16 operand
// arm of _cnn_update_kernel: every _dot32 of cnn_forward, the heads'
// gradients and cnn_encoder_bwd rounds both operands): the BF16 template
// parameter of the three kernels and the packing. The tower runs its bf16
// design on the bf16 tensor cores (cnn_mma.cuh tower_fwd_b16,
// tower_bwd_b16: operand rows stored once as bf16, m16n8k16 products; the
// backward BWD_BLOCKS_B16 blocks, TBB_PER_SM an SM), gWt and gbt too
// (cnn_gemm_kernel<true>: mma.cuh grad_b16_tile, windows of 64 samples
// folded with IEEE adds); the heads, their gradients and dh stay on the
// CUDA cores and round both operands (mma.cuh op_value; each product exact
// in fp32). The bias sums (gbt, gb1, gb0, the heads' b) stay fp32 sums of
// fp32 values.
//
// What bounds it on an H100: per sample ~958k matrix multiply-adds of the
// tower (the forward 369k, the weight gradients 369k, dX2 74k and dX1 147k;
// the kernels add conv0's re-run, 147k) at the 3xTF32 rate (3 TF32
// products at 495 TFLOP/s: 165 TFLOP/s of fp32-accurate products; the bf16
// arm's at 989), and the rest (the render's 2 x 2,304 expf, the heads,
// the fp32 arm's gWt, 74k multiply-adds, on the fp32 cores) at 67 TFLOP/s;
// the planes and the scratch's traffic are far below the memory rate's
// share.

#include <cuda_runtime.h>

#include <cstdint>

#include "cnn_mma.cuh"

namespace drone {

constexpr int N_UPSTATS = 8;
// Block counts: constants, so the order of the sums never depends on the
// card. The forward takes two blocks an SM of an H100, the backward one.
constexpr int FWD_BLOCKS = 264;
constexpr int BWD_BLOCKS = 132;
constexpr int BWD_BLOCKS_B16 = 132 * TBB_PER_SM;  // the bf16 arm's
// a forward block's partial row: [head W, head b, value W, value b | the 8
// stats]; a backward block's: [W0 b0 W1 b1] (OFF_WT floats)
constexpr int N_HEADS = OFF_LS - OFF_HW;                    // 645
constexpr int FP_W = N_HEADS + N_UPSTATS;
constexpr int GH_PER = (5 * (CNN_H + 1) + TM_THREADS - 1) / TM_THREADS;
constexpr int GPT = CNN_H * (CNN_X2 + 1);  // a gemm partial row: [gWt | gbt]
constexpr int GT = 64;  // product tile (rows and columns)
constexpr int GK = 16;  // samples per product step

struct UpdArgs {
  const float* planes;  // (T, 21, n)
  const float* advret;  // (2, T, n)
  const int* perm;      // (n_sel,) row blocks of the minibatch
  const float* theta;   // flat parameters
  const float4* pk;     // packed weights (cnn_mma.cuh PK_*)
  const float* grid;    // pixel coordinates (2, 576)
  float* x2s;           // (tch, 576, NL) this chunk's trunk inputs
  float* dzs;           // (tch, 128, NL) this chunk's dzt
  float* fpart;         // (Gf, FP_W) this chunk's forward partial rows
  int n, T, rbl, NL, tch, chunk, n_tiles;
};

template <bool BF16>
__global__ void __launch_bounds__(TM_THREADS, 2)
cnn_fwd_kernel(UpdArgs A, UConsts co) {
  constexpr int L = TM_L, S = TM_S;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  float* rows = tf_rows<BF16>(sm);
  float* sp = rows + TF_SP * S;   // TFB_SP too
  float* hh = tf_h<BF16>(sm);     // h, over the conv0 output rows
  float* dmv = rows + TF_XR * S;  // dm, g_v [5][S], over the patch rows
                                  // (TFB_XR too)
  const int tid = threadIdx.x, n = A.n, NL = A.NL;
  tower_load_w0<BF16>(sm, A.pk);  // before the first tile's barriers
  float ls[4], stdv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ls[k] = A.theta[OFF_LS + k];
    stdv[k] = expf(ls[k]);
  }
  float stv[N_UPSTATS], gh[GH_PER];
#pragma unroll
  for (int k = 0; k < N_UPSTATS; ++k) stv[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < GH_PER; ++k) gh[k] = 0.0f;
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

    // ---- the tower's forward, X2 to the scratch -------------------------
    tower_forward<BF16>(sm, A.theta, A.pk, A.grid, [&](int q1,
                                                       const float* y1) {
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

    // ---- the heads and the PPO surrogate's gradients (K3's _head_grads) ---
    if (tid < L) {
      float m[4], v, a[4], dm[4], g_v, st[N_UPSTATS];
      cnn_heads<BF16>(hh, S, tid, A.theta, m, v);
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
    // the heads' gradients: [dm; g_v] h^T and their sums, entry e = r *
    // 129 + u always thread e % 256's
#pragma unroll
    for (int k = 0; k < GH_PER; ++k) {
      const int e = tid + k * TM_THREADS;
      if (e >= 5 * (CNN_H + 1)) break;
      const int r = e / (CNN_H + 1), u = e % (CNN_H + 1);
      float s = 0.0f;
      if (u < CNN_H) {
        for (int l = 0; l < L; ++l)
          s = __fmaf_rn(op_value<BF16>(dmv[r * S + l]),
                        op_value<BF16>(hh[u * S + l]), s);
      } else {
        for (int l = 0; l < L; ++l) s = s + dmv[r * S + l];
      }
      gh[k] = gh[k] + s;
    }
    // dzt = (Hw^T dm + Vw^T g_v) * (h > 0), to the scratch
    for (int e = tid; e < CNN_H * L; e += blockDim.x) {
      const int u = e / L, l = e % L;
      float d = op_value<BF16>(__ldg(A.theta + OFF_HW + u)) *
                op_value<BF16>(dmv[l]);
#pragma unroll
      for (int k = 1; k < 4; ++k)
        d = __fmaf_rn(op_value<BF16>(__ldg(A.theta + OFF_HW + k * CNN_H + u)),
                      op_value<BF16>(dmv[k * S + l]), d);
      d = d + op_value<BF16>(__ldg(A.theta + OFF_VW + u)) *
                  op_value<BF16>(dmv[4 * S + l]);
      dzs[(size_t)u * NL + l] = d * (hh[u * S + l] > 0.0f ? 1.0f : 0.0f);
    }
  }

  // this block's partial row
  float* part = A.fpart + (size_t)blockIdx.x * FP_W;
#pragma unroll
  for (int k = 0; k < GH_PER; ++k) {
    const int e = tid + k * TM_THREADS;
    if (e >= 5 * (CNN_H + 1)) break;
    const int r = e / (CNN_H + 1), u = e % (CNN_H + 1);
    if (r < 4)
      part[u < CNN_H ? r * CNN_H + u : 4 * CNN_H + r] = gh[k];
    else
      part[(OFF_VW - OFF_HW) + u] = gh[k];  // value W then value b
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
    part[N_HEADS + tid] = s;
  }
}

// The split-K product of gWt and gbt: C (M x N) = sum_s A[m][s] B[n][s]
// with the bias sums sum_s A[m][s] as column N, over the chunk's samples
// (s = t * NL + lane); block (i, j, kc) takes the 64 x 64 tile (i, j) over
// CK lanes of one step and writes its own partial row (row0 + kc). fp32:
// on the fp32 cores. BF16: on the bf16 tensor cores (mma.cuh grad_b16_tile:
// each window of 64 samples from zero, folded with IEEE adds; GB_SMEM
// bytes of dynamic shared memory), the bias sums of the fp32 values.
struct GemmPair {
  const float* a;
  int ra, M;
  const float* b;
  int rb, N;
};

template <bool BF16>
__global__ void __launch_bounds__(256)
cnn_gemm_kernel(GemmPair p, int NL, int CK, float* __restrict__ partial,
                 int ptot, int row0) {
  if constexpr (BF16) {
    extern __shared__ float4 smem4[];
    const int kc = blockIdx.z, per_t = NL / CK;
    const int t = kc / per_t, lane0 = (kc % per_t) * CK;
    grad_b16_tile(p.a + (size_t)t * p.ra * NL + lane0,
                  p.b + (size_t)t * p.rb * NL + lane0, p.M, p.N, NL, CK,
                  blockIdx.x * GB_T, blockIdx.y * GB_T, blockIdx.y == 0,
                  reinterpret_cast<uint16_t*>(smem4),
                  partial + (size_t)(row0 + kc) * ptot, p.N + 1);
  } else {
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
          const float ai = ar[i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(ai, br[j], acc[i][j]);
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
}

// grads[q] for every flat parameter q and the 8 stat sums: the sum, in
// row order, over the RB backward block rows (W0 .. b1), the RG gemm rows
// (Wt, bt) or the RF forward block rows (the heads, log_std and the stats);
// log_std's gradient is its stat sums minus ent_coef.
__global__ void cnn_reduce_kernel(const float* __restrict__ bpart, int RB,
                                  const float* __restrict__ gpart, int RG,
                                  const float* __restrict__ fpart, int RF,
                                  float ent_coef, float* __restrict__ grads,
                                  float* __restrict__ stats) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= CNN_P + N_UPSTATS) return;
  float s = 0.0f;
  if (q < OFF_WT) {
    for (int r = 0; r < RB; ++r) s = s + bpart[(size_t)r * OFF_WT + q];
    grads[q] = s;
    return;
  }
  if (q < OFF_HW) {
    const int j = q - OFF_WT;
    const int e = q < OFF_BT ? (j / CNN_X2) * (CNN_X2 + 1) + j % CNN_X2
                             : (q - OFF_BT) * (CNN_X2 + 1) + CNN_X2;
    for (int r = 0; r < RG; ++r) s = s + gpart[(size_t)r * GPT + e];
    grads[q] = s;
    return;
  }
  int e;
  if (q >= CNN_P) e = N_HEADS + (q - CNN_P);
  else if (q >= OFF_LS) e = N_HEADS + 4 + (q - OFF_LS);
  else e = q - OFF_HW;
  for (int r = 0; r < RF; ++r) s = s + fpart[(size_t)r * FP_W + e];
  if (q >= CNN_P)
    stats[q - CNN_P] = s;
  else
    grads[q] = q >= OFF_LS ? s - ent_coef : s;
}

}  // namespace drone

// C interface (ctypes). ptrs: host array of device pointers [planes,
// advret, perm, theta, pk, grid, x2s, dzs, fpart, bpart, gpart, grads,
// stats]; the packed weights pk (PK_TOTAL float4s; the bf16 arm PKB_TOTAL
// uint4s), the scratch x2s (tch, 576, NL) and dzs (tch, 128, NL), the
// partial rows fpart (n_chunks * Gf, FP_W), bpart (n_chunks * Gb, OFF_WT)
// and gpart (n_chunks * tch * NL / CK, 128 * 577). dims: [n, T, rbl, NL,
// tch, CK, Gf, Gb (up to BWD_BLOCKS; the bf16 arm's BWD_BLOCKS_B16), the
// forward's and the backward's shared bytes as the wrapper counts them
// (tf_smem, tb_smem of the arm), bf16: 1 for the bf16 operand arm, 0 for
// 3xTF32]. consts: [inv_m,
// clip_lo, clip_hi, clip_eps, vf_clip, half_vf_coef, ent_coef]. Returns the
// cudaError_t of the launches.
extern "C" int drone_cnn_update(const uint64_t* ptrs, const int* dims,
                                const float* consts, void* stream) {
  using namespace drone;
  const int n = dims[0], T = dims[1], rbl = dims[2], NL = dims[3];
  const int tch = dims[4], CK = dims[5], Gf = dims[6], Gb = dims[7];
  if (dims[10] < 0 || dims[10] > 1) return (int)cudaErrorInvalidValue;
  const bool bf16 = dims[10] != 0;
  if (n <= 0 || T <= 0 || tch <= 0 || T % tch != 0 || rbl % 128 != 0 ||
      NL % rbl != 0 || NL % TM_L != 0 || CK % (bf16 ? GB_T : GK) != 0 ||
      NL % CK != 0 || Gf <= 0 || Gf > FWD_BLOCKS || Gb <= 0 ||
      Gb > (bf16 ? BWD_BLOCKS_B16 : BWD_BLOCKS) || dims[8] != tf_smem(bf16) ||
      dims[9] != tb_smem(bf16))
    return (int)cudaErrorInvalidValue;
  const float** ptr = reinterpret_cast<const float**>(const_cast<uint64_t*>(ptrs));
  UpdArgs A;
  A.planes = ptr[0];
  A.advret = ptr[1];
  A.perm = reinterpret_cast<const int*>(ptr[2]);
  A.theta = ptr[3];
  float4* pk = reinterpret_cast<float4*>(const_cast<float*>(ptr[4]));
  A.pk = pk;
  A.grid = ptr[5];
  A.x2s = const_cast<float*>(ptr[6]);
  A.dzs = const_cast<float*>(ptr[7]);
  float* fpart = const_cast<float*>(ptr[8]);
  float* bpart = const_cast<float*>(ptr[9]);
  float* gpart = const_cast<float*>(ptr[10]);
  float* grads = const_cast<float*>(ptr[11]);
  float* stats = const_cast<float*>(ptr[12]);
  A.n = n;
  A.T = T;
  A.rbl = rbl;
  A.NL = NL;
  A.tch = tch;
  A.n_tiles = tch * (NL / TM_L);
  if (Gf > A.n_tiles || Gb > A.n_tiles) return (int)cudaErrorInvalidValue;
  const UConsts co{consts[0], consts[1], consts[2], consts[3],
                   consts[4], consts[5], consts[6]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fwd = bf16 ? cnn_fwd_kernel<true> : cnn_fwd_kernel<false>;
  auto bwd = bf16 ? tower_bwd_kernel<true> : tower_bwd_kernel<false>;
  auto gemm = bf16 ? cnn_gemm_kernel<true> : cnn_gemm_kernel<false>;
  const int fsm = tf_smem(bf16), bsm = tb_smem(bf16);
  const int gsm = bf16 ? GB_SMEM : 0;
  cudaError_t err = cudaFuncSetAttribute(
      fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, fsm);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      bwd, cudaFuncAttributeMaxDynamicSharedMemorySize, bsm);
  if (err != cudaSuccess) return (int)err;
  if (bf16)
    pack_tower_kernel<true><<<(PKB_TOTAL + 255) / 256, 256, 0, s>>>(
        A.theta, pk, PKB_TOTAL);
  else
    pack_tower_kernel<false><<<(PK_TOTAL + 255) / 256, 256, 0, s>>>(
        A.theta, pk, PK_TOTAL);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = T / tch, nk = tch * (NL / CK);
  const GemmPair gp{A.dzs, CNN_H, CNN_H, A.x2s, CNN_X2, CNN_X2};
  const dim3 grid((CNN_H + GT - 1) / GT, (CNN_X2 + GT - 1) / GT, nk);
  TowerBwdArgs B;
  B.obs = A.planes + (size_t)TP_OBS0 * n;
  B.obs_step = (size_t)N_TRAJ * n;
  B.obs_row = n;
  B.perm = A.perm;
  B.rbl = rbl;
  B.dzs = A.dzs;
  B.x2s = A.x2s;
  B.theta = A.theta;
  B.pk = pk;
  B.grid = A.grid;
  B.partial = bpart;
  B.ptot = OFF_WT;
  B.NL = NL;
  B.n_tiles = A.n_tiles;
  for (int c = 0; c < n_chunks; ++c) {
    A.chunk = c;
    A.fpart = fpart + (size_t)c * Gf * FP_W;
    fwd<<<Gf, TM_THREADS, fsm, s>>>(A, co);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    B.t0 = c * tch;
    B.row0 = c * Gb;
    bwd<<<Gb, TM_THREADS, bsm, s>>>(B);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gemm<<<grid, 256, gsm, s>>>(gp, NL, CK, gpart, GPT, c * nk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cnn_reduce_kernel<<<(CNN_P + N_UPSTATS + 255) / 256, 256, 0, s>>>(
      bpart, n_chunks * Gb, gpart, n_chunks * nk, fpart, n_chunks * Gf,
      co.ent_coef, grads, stats);
  return (int)cudaGetLastError();
}
