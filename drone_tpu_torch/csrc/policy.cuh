// policy.cuh — the pieces of a Gaussian policy every family shares, as
// CUDA device functions: the Box-Muller draw (K2, K5), the action's
// log-prob (K2, K6), the trajectory planes and the PPO head's gradients
// (K3, K7). The MLP tower itself runs on the tensor cores
// (tower_mma.cuh).
//
// Ports drone_tpu/ops/pallas_acting.py `_gauss4_planes` (Box-Muller over
// the lane's threefry stream) and pallas_acting_traj.py `_sample_logp`.
#pragma once

#include <cstdint>

#include "env.cuh"

namespace drone {

constexpr int MAX_HIDDEN = 8;
constexpr int MAX_WIDTH = 256;
// float32(2*pi), as drone_tpu's jnp.float32(_TWO_PI) rounds it (0x40C90FDB).
constexpr float TWO_PI = 6.28318548202514648438f;
// float32(0.5 * log(2 pi)) (0x3F6B3F8E), as jnp.float32(_HALF_LOG_2PI).
constexpr float HALF_LOG_2PI = 0.91893851757049560547f;

// The trajectory planes that K2 (acting_traj.cu) writes and K3 (update.cu)
// reads, per step and lane, in the reference's TP_* order
// (pallas_acting_traj.py): obs(13) act(4) logp value reward done.
// ops/cuda_acting_traj.py holds the same layout for the host.
constexpr int N_TRAJ = OBS_DIM + 8;  // 21
constexpr int TP_OBS0 = 0;
constexpr int TP_ACT0 = OBS_DIM;
constexpr int TP_LOGP = OBS_DIM + 4;
constexpr int TP_VAL = OBS_DIM + 5;
constexpr int TP_REW = OBS_DIM + 6;
constexpr int TP_DONE = OBS_DIM + 7;

// _gauss4_planes: 4 standard normals at blocks NOISE_BLOCK0 + 2*step (+1).
__device__ __forceinline__ void gauss4(uint32_t k0, uint32_t k1, uint32_t e,
                                       int stp, float z[4]) {
  const uint32_t jb = NOISE_BLOCK0 + 2u * (uint32_t)stp;
  uint32_t b0, b1, b2, b3;
  threefry2x32(k0, k1, e, jb, b0, b1);
  threefry2x32(k0, k1, e, jb + 1u, b2, b3);
  const float u1 = uniform01(b0), u2 = uniform01(b1);
  const float u3 = uniform01(b2), u4 = uniform01(b3);
  // 1-u in (0, 1]: log never sees 0
  const float r1 = sqrtf(-2.0f * logf(1.0f - u1));
  const float r2 = sqrtf(-2.0f * logf(1.0f - u3));
  const float a1 = TWO_PI * u2;
  const float a2 = TWO_PI * u4;
  z[0] = r1 * cosf(a1);
  z[1] = r1 * sinf(a1);
  z[2] = r2 * cosf(a2);
  z[3] = r2 * sinf(a2);
}

// _sample_logp: the action (the mean, plus std * z when stochastic) and the
// log-prob rebuilt from the stored action. Shared by K2 and K6.
__device__ __forceinline__ void sample_logp(const float m[4], const float z[4],
                                            const float ls[4],
                                            const float stdv[4],
                                            bool stochastic, float a[4],
                                            float& logp) {
  float lp[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k] = stochastic ? m[k] + stdv[k] * z[k] : m[k];
    const float zr = (a[k] - m[k]) / stdv[k];
    lp[k] = -0.5f * (zr * zr) - ls[k] - HALF_LOG_2PI;
  }
  logp = ((lp[0] + lp[1]) + lp[2]) + lp[3];
}

// PPO constants of an update (pallas_update.UpdateConsts, expanded).
struct UConsts {
  float inv_m, clip_lo, clip_hi, clip_eps, vf_clip, half_vf_coef, ent_coef;
};

// _head_grads for one sample: the clipped-PPO surrogate and value loss at
// the means m and value v. Outputs the gradients of the mean-loss w.r.t. m
// (dm) and v (g_v), and the 8 stat terms (policy loss, value loss,
// approx-KL, clip fraction, the 4 log_std gradient terms). max/clip
// subgradients: the first branch wins ties; clip passes gradient inside the
// closed interval. K7's (update_lstm.cu); K3 (update.cu) computes the same
// with four threads a sample.
__device__ __forceinline__ void head_grads(const float m[4], float v,
                                           const float a[4], float logp_old,
                                           float v_old, float adv, float ret,
                                           const float ls[4],
                                           const float stdv[4],
                                           const UConsts& co, float dm[4],
                                           float& g_v, float st[8]) {
  float z[4], lp = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    z[k] = (a[k] - m[k]) / stdv[k];
    const float term = -0.5f * (z[k] * z[k]) - ls[k] - HALF_LOG_2PI;
    lp = k == 0 ? term : lp + term;
  }
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
#pragma unroll
  for (int k = 0; k < 4; ++k) dm[k] = g_logp * (z[k] / expf(ls[k]));
  g_v = co.half_vf_coef * co.inv_m * dvl;
  st[0] = pg;
  st[1] = vl;
  st[2] = logp_old - lp;
  st[3] = fabsf(ratio - 1.0f) > co.clip_eps ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) st[4 + k] = g_logp * (z[k] * z[k] - 1.0f);
}

}  // namespace drone
