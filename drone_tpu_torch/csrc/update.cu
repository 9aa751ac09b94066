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
// each of its 19 trajectory planes and 2 advantage/return planes is one
// contiguous 256-byte run. A CUDA block of 256 threads takes tiles
// b, b + G, b + 2G, ... for a fixed G (at most MAX_BLOCKS), and per tile:
//   - loads the tile into shared memory, one row of 64 per plane;
//   - runs both towers forward (_tower_fwd), keeping every layer's
//     activations in shared memory (rows padded to 65 floats, which keeps
//     the reads of the products below free of bank conflicts);
//   - computes the clipped-PPO head gradients and the 8 stat values per
//     sample (_head_grads), one thread per sample;
//   - back-propagates (_tower_bwd): dW = dY @ In^T over the tile's
//     samples, then the input gradient W^T @ dY times the tanh derivative
//     overwrites the layer's input activations in place.
// Every one of these is a small matrix product (gemm4x4) in which a thread
// owns a 4 x 4 block of the result in registers, so each multiply-add
// costs half a shared-memory load instead of two.
// Each block sums its tiles into its own row of a partial-sum buffer in
// device memory (a thread always owns the same entries, so no atomics),
// and a second kernel adds the G rows in a fixed order. The result does not
// depend on launch order, so training on the card is deterministic and a
// resumed run repeats an uninterrupted one bit for bit.
//
// What bounds K3 on an H100: about 58k fp32 operations per sample at [64,
// 64] (two towers forward and backward), against 84 bytes of input; the
// operation bound is far above the bytes'. Its products run on the fp32
// cores from shared memory and L1 (a tensor-core tile is work for a later
// change).
//
// K4 design: one block of 1024 threads over the flat parameter buffer:
// a strided sum of squares, a tree reduction in shared memory in a fixed
// order, then the adam update per element. The learning rate (linear
// anneal, make_fused_lr) and the bias corrections are computed here from
// the step count, which lives on the device, so no optimizer step waits
// for the host. The formulas are _adam_math's, with bc = 1 - exp(c *
// log(beta)) and float32 constants. It moves ~0.2 MB, so its time is the
// launch's.

#include <cuda_runtime.h>

#include <cstdint>

#include "policy.cuh"  // the trajectory-plane layout, HALF_LOG_2PI

namespace drone {

constexpr int N_UPSTATS = 8;
constexpr int UPD_HIDDEN = 8;
constexpr int UPD_THREADS = 256;
constexpr int TILE = 64;
constexpr int SP = TILE + 1;
// 3 blocks per SM of an H100. A constant, so the order of the sums never
// depends on the card.
constexpr int MAX_BLOCKS = 396;
struct UTower {
  int n_hidden, nh;           // hidden layers; head outputs (4 or 1)
  int width[UPD_HIDDEN];      // hidden widths
  int w[UPD_HIDDEN + 1];      // offset of each layer's W (out, in) in theta;
                              // its bias follows W
};

struct UArgs {
  const float* planes;   // (T, 21, n)
  const float* advret;   // (2, T, n)
  const int* perm;       // (n_sel,) row-block indices
  const float* theta;    // flat parameters
  float* partial;        // (G, P + 8)
  int n, T, rbl, n_tiles, P, ls_off;
};

// One small matrix product of a tile, C (M x N) = sum_k A(m, k) B(k, n),
// with every thread owning a 4 x 4 block of C in registers: per k it loads
// 4 values of A and 4 of B for 16 multiply-adds. The blocks are laid out so
// that a warp holds 4 row blocks x 8 column blocks; with rows of SP = 65
// floats, its 4 (or 8) distinct shared-memory addresses per load fall in
// distinct banks. `op.a`/`op.b` read the operands, `epi(m0, n0, acc)`
// stores a finished block (rows >= M and columns >= N are never read and
// hold zeros).
template <class Op, class Epi>
__device__ __forceinline__ void gemm4x4(int M, int N, int K, const Op& op,
                                        const Epi& epi) {
  const int mb = (M + 3) / 4, nb = (N + 3) / 4;
  const int nb8 = (nb + 7) / 8;
  const int total = ((mb + 3) / 4) * nb8 * 32;
  for (int id = threadIdx.x; id < total; id += blockDim.x) {
    const int lane = id & 31, w = id >> 5;
    const int mi = (w / nb8) * 4 + (lane >> 3);
    const int ni = (w % nb8) * 8 + (lane & 7);
    if (mi >= mb || ni >= nb) continue;
    const int m0 = 4 * mi, n0 = 4 * ni;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < K; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = m0 + i < M ? op.a(m0 + i, k) : 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = n0 + j < N ? op.b(k, n0 + j) : 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    epi(m0, n0, acc);
  }
}

// A = W (out, in) in device memory, B = rows of the tile: the forward
// product W @ In (A(m, k) = W[m][k]) or the input gradient W^T @ dY
// (A(m, k) = W[k][m]).
struct WeightTimesRows {
  const float* W;
  int nin;
  bool transpose;
  const float* rows;  // shared memory, row k at rows + k * SP
  __device__ float a(int m, int k) const {
    return __ldg(W + (transpose ? k * nin + m : m * nin + k));
  }
  __device__ float b(int k, int n) const { return rows[k * SP + n]; }
};

// dW = dY @ In^T over the tile's samples: A(m, k) = dY[m][k], B(k, n) =
// In[n][k].
struct RowsTimesRowsT {
  const float* dy;
  const float* in;
  __device__ float a(int m, int k) const { return dy[m * SP + k]; }
  __device__ float b(int k, int n) const { return in[n * SP + k]; }
};

// _tower_fwd: layer l reads rows in_row.. (X for l = 0) and writes its
// outputs at out rows (hidden: tanh; head: linear, at head_row).
__device__ void tower_fwd(float* sm, const UTower& tw, int row0,
                          int head_row, const float* __restrict__ theta) {
  int nin = OBS_DIM, in_row = 0, out_row = row0;
  for (int l = 0; l <= tw.n_hidden; ++l) {
    const bool head = l == tw.n_hidden;
    const int nout = head ? tw.nh : tw.width[l];
    const int orow = head ? head_row : out_row;
    const float* W = theta + tw.w[l];
    const float* b = W + nout * nin;
    float* out = sm + orow * SP;
    gemm4x4(nout, TILE, nin, WeightTimesRows{W, nin, false, sm + in_row * SP},
            [&](int m0, int n0, const float (&acc)[4][4]) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if (m0 + i >= nout) break;
                const float bias = __ldg(b + m0 + i);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  const float v = acc[i][j] + bias;
                  out[(m0 + i) * SP + n0 + j] = head ? v : tanhf(v);
                }
              }
            });
    __syncthreads();
    in_row = orow;
    nin = nout;
    out_row += nout;
  }
}

// _tower_bwd: the head's output gradient is at head_row; a hidden layer's
// output gradient overwrites its activations. Adds the tile's dW and db
// into this block's partial row (each entry always by the same thread).
__device__ void tower_bwd(float* sm, const UTower& tw, int row0,
                          int head_row, const float* __restrict__ theta,
                          float* part, bool first) {
  int in_rows[UPD_HIDDEN + 1], nins[UPD_HIDDEN + 1];
  in_rows[0] = 0;
  nins[0] = OBS_DIM;
  int r = row0;
  for (int l = 1; l <= tw.n_hidden; ++l) {
    in_rows[l] = r;
    nins[l] = tw.width[l - 1];
    r += tw.width[l - 1];
  }
  for (int l = tw.n_hidden; l >= 0; --l) {
    const bool head = l == tw.n_hidden;
    const int nout = head ? tw.nh : tw.width[l];
    const float* dy = sm + (head ? head_row : in_rows[l + 1]) * SP;
    const int nin = nins[l];
    float* in = sm + in_rows[l] * SP;
    float* gW = part + tw.w[l];
    float* gb = gW + nout * nin;
    gemm4x4(nout, nin, TILE, RowsTimesRowsT{dy, in},
            [&](int m0, int n0, const float (&acc)[4][4]) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if (m0 + i >= nout) break;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  if (n0 + j >= nin) break;
                  float* g = gW + (m0 + i) * nin + n0 + j;
                  *g = first ? acc[i][j] : *g + acc[i][j];
                }
              }
            });
    for (int o = threadIdx.x; o < nout; o += blockDim.x) {
      float acc = 0.0f;
      for (int s = 0; s < TILE; ++s) acc = acc + dy[o * SP + s];
      gb[o] = first ? acc : gb[o] + acc;
    }
    if (l == 0) break;
    __syncthreads();
    gemm4x4(nin, TILE, nout,
            WeightTimesRows{theta + tw.w[l], nin, true, dy},
            [&](int m0, int n0, const float (&acc)[4][4]) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                if (m0 + i >= nin) break;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                  float* y = in + (m0 + i) * SP + n0 + j;
                  *y = acc[i][j] * (1.0f - *y * *y);
                }
              }
            });
    __syncthreads();
  }
}

__global__ void __launch_bounds__(UPD_THREADS, 3)
update_kernel(UArgs A, UTower ta, UTower tc, UConsts co) {
  extern __shared__ float sm[];
  int h_a = 0;
  for (int l = 0; l < ta.n_hidden; ++l) h_a += ta.width[l];
  const int RA = OBS_DIM;     // actor activations
  const int RC = RA + h_a;    // critic activations (same widths)
  const int HM = RC + h_a;    // 4 action means, then their gradients
  const int HV = HM + 4;      // value, then its gradient
  const int IN = HV + 1;      // a(4) logp_old v_old adv ret, then 8 stats
  const int PW = A.P + N_UPSTATS;
  float* part = A.partial + (size_t)blockIdx.x * PW;
  const int nc = A.rbl / TILE;
  float ls[4], stdv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ls[k] = A.theta[A.ls_off + k];
    stdv[k] = expf(ls[k]);
  }
  float st_acc = 0.0f;
  bool first = true;
  for (int tau = blockIdx.x; tau < A.n_tiles; tau += gridDim.x) {
    const int t = tau % A.T;
    const int rest = tau / A.T;
    const int lane0 = A.perm[rest / nc] * A.rbl + (rest % nc) * TILE;
    // the planes up to v_old (TP_VAL), then adv and ret
    for (int e = threadIdx.x; e < (TP_VAL + 3) * TILE; e += blockDim.x) {
      const int p = e / TILE, s = e % TILE;
      float v;
      if (p <= TP_VAL)
        v = A.planes[((size_t)t * N_TRAJ + p) * A.n + lane0 + s];
      else
        v = A.advret[((size_t)(p - TP_VAL - 1) * A.T + t) * A.n + lane0 + s];
      const int row = p < OBS_DIM ? p : IN + (p - OBS_DIM);
      sm[row * SP + s] = v;
    }
    __syncthreads();
    tower_fwd(sm, ta, RA, HM, A.theta);
    tower_fwd(sm, tc, RC, HV, A.theta);

    // _head_grads, one thread per sample
    if (threadIdx.x < TILE) {
      const int s = threadIdx.x;
      float m[4], a[4], dm[4], g_v, st[N_UPSTATS];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m[k] = sm[(HM + k) * SP + s];
        a[k] = sm[(IN + k) * SP + s];
      }
      head_grads(m, sm[HV * SP + s], a, sm[(IN + 4) * SP + s],
                 sm[(IN + 5) * SP + s], sm[(IN + 6) * SP + s],
                 sm[(IN + 7) * SP + s], ls, stdv, co, dm, g_v, st);
#pragma unroll
      for (int k = 0; k < 4; ++k) sm[(HM + k) * SP + s] = dm[k];
      sm[HV * SP + s] = g_v;
#pragma unroll
      for (int k = 0; k < N_UPSTATS; ++k) sm[(IN + k) * SP + s] = st[k];
    }
    __syncthreads();
    if (threadIdx.x < N_UPSTATS) {
      float tile_sum = 0.0f;
      for (int s = 0; s < TILE; ++s) tile_sum = tile_sum + sm[(IN + threadIdx.x) * SP + s];
      st_acc = st_acc + tile_sum;
    }
    tower_bwd(sm, ta, RA, HM, A.theta, part, first);
    __syncthreads();
    tower_bwd(sm, tc, RC, HV, A.theta, part, first);
    __syncthreads();
    first = false;
  }
  if (threadIdx.x < N_UPSTATS) {
    part[A.P + threadIdx.x] = st_acc;
    if (threadIdx.x >= 4) part[A.ls_off + threadIdx.x - 4] = st_acc;
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

constexpr int ADAM_THREADS = 1024;

struct AdamC {
  float lr, total_steps, b1, b2, eps, clip, log_b1, log_b2;
  int anneal;
};

__global__ void __launch_bounds__(ADAM_THREADS)
adam_kernel(float* __restrict__ theta, const float* __restrict__ grads,
            float* __restrict__ mu, float* __restrict__ nu,
            float* __restrict__ count, int P, AdamC ac) {
  __shared__ float red[ADAM_THREADS];
  float ss = 0.0f;
  for (int e = threadIdx.x; e < P; e += blockDim.x) ss = ss + grads[e] * grads[e];
  red[threadIdx.x] = ss;
  __syncthreads();
  for (int w = ADAM_THREADS / 2; w > 0; w /= 2) {
    if (threadIdx.x < w) red[threadIdx.x] = red[threadIdx.x] + red[threadIdx.x + w];
    __syncthreads();
  }
  const float gn = sqrtf(red[0]);
  const float scale = gn > ac.clip ? ac.clip / gn : 1.0f;
  const float cnt = count[0];
  const float lr = ac.anneal ? ac.lr * (1.0f - fminf(cnt / ac.total_steps, 1.0f))
                             : ac.lr;
  const float c = cnt + 1.0f;
  const float bc1 = 1.0f - expf(c * ac.log_b1);
  const float bc2 = 1.0f - expf(c * ac.log_b2);
  for (int e = threadIdx.x; e < P; e += blockDim.x) {
    const float gc = grads[e] * scale;
    const float mu2 = ac.b1 * mu[e] + (1.0f - ac.b1) * gc;
    const float nu2 = ac.b2 * nu[e] + (1.0f - ac.b2) * (gc * gc);
    const float upd = -lr * (mu2 / bc1) / (sqrtf(nu2 / bc2) + ac.eps);
    theta[e] = theta[e] + upd;
    mu[e] = mu2;
    nu[e] = nu2;
  }
  __syncthreads();  // every thread has read the count
  if (threadIdx.x == 0) count[0] = c;
}

}  // namespace drone

// C interface (ctypes). Device pointers: planes, advret, perm, theta,
// partial ((G, P + 8) scratch), grads (P), stats (8). Host: layout ints
// [n_hidden, width[UPD_HIDDEN], actor W offsets[UPD_HIDDEN + 1], critic W
// offsets[UPD_HIDDEN + 1], P, ls_off]; consts floats [inv_m, clip_lo,
// clip_hi, clip_eps, vf_clip, half_vf_coef, ent_coef]. Returns the
// cudaError_t of the launches.
extern "C" int drone_ppo_update(const float* planes, const float* advret,
                                const int* perm, const float* theta,
                                float* partial, float* grads, float* stats,
                                const int* layout, const float* consts, int n,
                                int T, int rbl, int n_sel, int G,
                                void* stream) {
  using namespace drone;
  const int nh = layout[0];
  if (n <= 0 || T <= 0 || n_sel <= 0 || rbl % TILE != 0 || nh < 0 ||
      nh > UPD_HIDDEN)
    return (int)cudaErrorInvalidValue;
  UTower ta, tc;
  ta.n_hidden = tc.n_hidden = nh;
  ta.nh = 4;
  tc.nh = 1;
  int h = 0;
  for (int l = 0; l < UPD_HIDDEN; ++l) {
    ta.width[l] = tc.width[l] = layout[1 + l];
    if (l < nh) h += layout[1 + l];
  }
  for (int l = 0; l <= UPD_HIDDEN; ++l) {
    ta.w[l] = layout[1 + UPD_HIDDEN + l];
    tc.w[l] = layout[2 + 2 * UPD_HIDDEN + l];
  }
  UArgs A{planes, advret, perm, theta, partial, n, T, rbl,
          n_sel * (rbl / TILE) * T, layout[3 + 3 * UPD_HIDDEN],
          layout[4 + 3 * UPD_HIDDEN]};
  if (G <= 0 || G > MAX_BLOCKS || G > A.n_tiles) return (int)cudaErrorInvalidValue;
  const UConsts co{consts[0], consts[1], consts[2], consts[3],
                   consts[4], consts[5], consts[6]};
  const int rows = OBS_DIM + 2 * h + 5 + 8;
  const size_t smem = sizeof(float) * (size_t)rows * SP;
  cudaError_t err = cudaFuncSetAttribute(
      update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  update_kernel<<<G, UPD_THREADS, smem, s>>>(A, ta, tc, co);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int PW = A.P + N_UPSTATS;
  reduce_kernel<<<(PW + 255) / 256, 256, 0, s>>>(partial, G, A.P, A.ls_off,
                                                 co.ent_coef, grads, stats);
  return (int)cudaGetLastError();
}

// theta, grads, mu, nu (P floats) and count (1 float) are device memory;
// consts: host floats [lr, total_steps, b1, b2, eps, clip, log_b1,
// log_b2]; anneal: 0 or 1. Updates theta, mu, nu and count in place.
extern "C" int drone_fused_adam(float* theta, const float* grads, float* mu,
                                float* nu, float* count, int P,
                                const float* consts, int anneal,
                                void* stream) {
  using namespace drone;
  if (P <= 0) return (int)cudaErrorInvalidValue;
  const AdamC ac{consts[0], consts[1], consts[2], consts[3], consts[4],
                 consts[5], consts[6], consts[7], anneal};
  adam_kernel<<<1, ADAM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      theta, grads, mu, nu, count, P, ac);
  return (int)cudaGetLastError();
}
