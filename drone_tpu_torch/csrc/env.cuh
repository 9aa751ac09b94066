// env.cuh — the drone env as CUDA device functions, shared by every
// rollout kernel of drone_tpu_torch (rollout.cu, acting.cu,
// acting_traj.cu, acting_lstm.cu, acting_cnn.cu).
//
// Ports, once, the device functions of drone_tpu/ops/pallas_rollout.py:
// _deriv, _normalize_quat, _integrate, _gate_target, _sample_waypoint,
// _fresh_state, _env_step, accumulate, obs_matrix, _uniform, and threefry
// (drone_tpu/prng.py) on native uint32_t. One thread owns one lane; the
// lane's state lives in registers (struct Carry) for the whole loop.
//
// PARITY CONTRACT: bitwise float32 equality with drone_tpu_torch/env.py,
// drone_tpu/env.py and oracle/drone_oracle.c. Every expression keeps their
// evaluation order. It holds only when
//   - the sources are built with --fmad=false, -prec-div=true,
//     -prec-sqrt=true and never --use_fast_math (no contraction, IEEE
//     division and square root; ops/cuda_build.py sets the flags);
//   - every floating literal carries the f suffix (a bare 2.0 promotes the
//     expression to double and rounds differently);
//   - constants are the float32 values drone_tpu's weak typing rounds to:
//     1/6 -> 0x3E2AAAAB, written below as its exact decimal value.
// tests/test_torch_cuda_rollout.py scans these sources for bare literals.
#pragma once

#include <cstdint>

namespace drone {

constexpr int OBS_DIM = 13;
constexpr int MAX_GATES = 8;
constexpr uint32_t WP_BLOCK0 = 16u;
constexpr uint32_t ACTION_BLOCK0 = 0x40000000u;
constexpr uint32_t NOISE_BLOCK0 = 0x60000000u;
constexpr int NF = 19;      // f32 state planes (oracle fstate order)
constexpr int NU = 4;       // u32 planes: reset_count, key0, key1, wp_count
constexpr int NI = 2;       // i32 planes: step, gate_idx
constexpr int N_STATS = 5;  // reward, episodes, ep_return, ep_length, ep_return^2

enum { TASK_HOVER = 0, TASK_WAYPOINT = 1, TASK_RACING = 2 };
enum { INTEG_EULER = 0, INTEG_RK4 = 1 };

// float32(1/6): the h6 = dt * (1/6) constant of dynamics.rk4_step.
constexpr float SIXTH = 0.16666667163372039795f;

// Env params, in the order of drone_tpu/ops/pallas_rollout.py _PF, then the
// target and the gate centers: 57 floats, then 2 ints. The wrapper packs
// them into device buffers (ops/cuda_rollout.py pack_params) and each block
// stages them into shared memory (load_params), where every thread of a
// warp reads the same word at once.
struct EnvP {
  float mass, gravity, arm_l, thrust_max, torque_coef;
  float inertia_x, inertia_y, inertia_z, drag_lin, drag_ang, dt;
  float bound, tilt_min, c_vel, c_spin, c_act, crash_penalty;
  float reach_bonus, reach_tol2;
  float pos_radius, vel_max_init, rot_max_init, omega_max_init;
  float dr_mass_lo, dr_mass_hi, dr_thrust_lo, dr_thrust_hi;
  float wp_box, wp_zmin, wp_zmax;
  float tgx, tgy, tgz;
  float gates[MAX_GATES * 3];
  int horizon, n_gates;
};
constexpr int NPF = 57;
static_assert(sizeof(EnvP) == NPF * 4 + 2 * 4, "EnvP layout");

// Stage the params into the block's shared copy. Every thread of the block
// must call it (it ends with a barrier).
__device__ __forceinline__ void load_params(const float* __restrict__ pf,
                                            const int* __restrict__ pi,
                                            EnvP& sP) {
  for (int k = threadIdx.x; k < NPF; k += blockDim.x)
    reinterpret_cast<float*>(&sP)[k] = pf[k];
  if (threadIdx.x == 0) {
    sP.horizon = pi[0];
    sP.n_gates = pi[1];
  }
  __syncthreads();
}

// One lane's carried state (the canonical carry tuple of pallas_rollout).
struct Carry {
  float px, py, pz, vx, vy, vz, qw, qx, qy, qz, wx, wy, wz, tx, ty, tz;
  float drm, drt, epret;
  int stp;
  uint32_t wp;
  int gi;
  uint32_t rc, k0, k1;
};

// ---------------------------------------------------------------------------
// Counter-based RNG (drone_tpu/prng.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void tf_round(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = rotl32(x1, r);
  x1 ^= x0;
}

// Threefry-2x32, 20 rounds. KAT: key=0, ctr=0 -> (0x6b200159, 0x99ba4efe).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t& o0, uint32_t& o1) {
  const uint32_t k2 = 0x1BD11BDAu ^ k0 ^ k1;
  x0 += k0;
  x1 += k1;
  tf_round(x0, x1, 13); tf_round(x0, x1, 15);
  tf_round(x0, x1, 26); tf_round(x0, x1, 6);
  x0 += k1; x1 += k2 + 1u;
  tf_round(x0, x1, 17); tf_round(x0, x1, 29);
  tf_round(x0, x1, 16); tf_round(x0, x1, 24);
  x0 += k2; x1 += k0 + 2u;
  tf_round(x0, x1, 13); tf_round(x0, x1, 15);
  tf_round(x0, x1, 26); tf_round(x0, x1, 6);
  x0 += k0; x1 += k1 + 3u;
  tf_round(x0, x1, 17); tf_round(x0, x1, 29);
  tf_round(x0, x1, 16); tf_round(x0, x1, 24);
  x0 += k1; x1 += k2 + 4u;
  tf_round(x0, x1, 13); tf_round(x0, x1, 15);
  tf_round(x0, x1, 26); tf_round(x0, x1, 6);
  x0 += k2; x1 += k0 + 5u;
  o0 = x0;
  o1 = x1;
}

// uint32 bits -> float32 uniform in [0, 1) (prng.bits_to_uniform).
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

// The in-kernel action stream (pallas_rollout's random actions): 4
// uniforms in [-1, 1) from blocks ACTION_BLOCK0 + 2 * step (+1) of the
// lane's current episode.
__device__ __forceinline__ void stream_actions(uint32_t k0, uint32_t k1,
                                               uint32_t rc, int stp,
                                               float& a0, float& a1,
                                               float& a2, float& a3) {
  const uint32_t jb = ACTION_BLOCK0 + 2u * (uint32_t)stp;
  uint32_t b0, b1, b2, b3;
  threefry2x32(k0, k1, rc, jb, b0, b1);
  threefry2x32(k0, k1, rc, jb + 1u, b2, b3);
  a0 = uniform01(b0) * 2.0f - 1.0f;
  a1 = uniform01(b1) * 2.0f - 1.0f;
  a2 = uniform01(b2) * 2.0f - 1.0f;
  a3 = uniform01(b3) * 2.0f - 1.0f;
}

// ---------------------------------------------------------------------------
// Dynamics (drone_tpu/dynamics.py)
// ---------------------------------------------------------------------------

// s = (px py pz vx vy vz qw qx qy qz wx wy wz); d = ds/dt.
__device__ __forceinline__ void deriv(const float s[13], float F0, float F1,
                                      float F2, float F3, float mass_eff,
                                      const EnvP& P, float d[13]) {
  const float vx = s[3], vy = s[4], vz = s[5];
  const float qw = s[6], qx = s[7], qy = s[8], qz = s[9];
  const float wx = s[10], wy = s[11], wz = s[12];
  const float T = F0 + F1 + F2 + F3;
  const float uzx = 2.0f * (qx * qz + qw * qy);
  const float uzy = 2.0f * (qy * qz - qw * qx);
  const float uzz = 1.0f - 2.0f * (qx * qx + qy * qy);
  const float Tm = T / mass_eff;
  d[0] = vx;
  d[1] = vy;
  d[2] = vz;
  d[3] = Tm * uzx - P.drag_lin * vx / mass_eff;
  d[4] = Tm * uzy - P.drag_lin * vy / mass_eff;
  d[5] = Tm * uzz - P.drag_lin * vz / mass_eff - P.gravity;
  const float taux = P.arm_l * ((F1 + F3) - (F0 + F2)) - P.drag_ang * wx;
  const float tauy = P.arm_l * ((F2 + F3) - (F0 + F1)) - P.drag_ang * wy;
  const float tauz = P.torque_coef * ((F1 + F2) - (F0 + F3)) - P.drag_ang * wz;
  const float s_ = qx * wx + qy * wy + qz * wz;
  d[6] = -0.5f * s_;
  d[7] = 0.5f * (qw * wx + qy * wz - qz * wy);
  d[8] = 0.5f * (qw * wy - qx * wz + qz * wx);
  d[9] = 0.5f * (qw * wz + qx * wy - qy * wx);
  d[10] = (taux - (wy * (P.inertia_z * wz) - wz * (P.inertia_y * wy))) / P.inertia_x;
  d[11] = (tauy - (wz * (P.inertia_x * wx) - wx * (P.inertia_z * wz))) / P.inertia_y;
  d[12] = (tauz - (wx * (P.inertia_y * wy) - wy * (P.inertia_x * wx))) / P.inertia_z;
}

// Quaternion renormalize in place (s[6..9]).
__device__ __forceinline__ void normalize_quat(float s[13]) {
  const float n2 = s[6] * s[6] + s[7] * s[7] + s[8] * s[8] + s[9] * s[9];
  const float n = sqrtf(n2);
  s[6] = s[6] / n;
  s[7] = s[7] / n;
  s[8] = s[8] / n;
  s[9] = s[9] / n;
}

template <int INTEG>
__device__ __forceinline__ void integrate(float s[13], float F0, float F1,
                                          float F2, float F3, float mass_eff,
                                          const EnvP& P) {
  if (INTEG == INTEG_EULER) {
    float d[13];
    deriv(s, F0, F1, F2, F3, mass_eff, P, d);
#pragma unroll
    for (int i = 0; i < 13; ++i) s[i] = s[i] + P.dt * d[i];
  } else {
    const float h2 = P.dt * 0.5f;
    const float h6 = P.dt * SIXTH;
    float k1[13], k2[13], k3[13], k4[13], t[13];
    deriv(s, F0, F1, F2, F3, mass_eff, P, k1);
#pragma unroll
    for (int i = 0; i < 13; ++i) t[i] = s[i] + h2 * k1[i];
    deriv(t, F0, F1, F2, F3, mass_eff, P, k2);
#pragma unroll
    for (int i = 0; i < 13; ++i) t[i] = s[i] + h2 * k2[i];
    deriv(t, F0, F1, F2, F3, mass_eff, P, k3);
#pragma unroll
    for (int i = 0; i < 13; ++i) t[i] = s[i] + P.dt * k3[i];
    deriv(t, F0, F1, F2, F3, mass_eff, P, k4);
#pragma unroll
    for (int i = 0; i < 13; ++i)
      s[i] = s[i] + h6 * (((k1[i] + 2.0f * k2[i]) + 2.0f * k3[i]) + k4[i]);
  }
  normalize_quat(s);
}

// ---------------------------------------------------------------------------
// Tasks and resets (drone_tpu/tasks.py, randomize.py, env.py)
// ---------------------------------------------------------------------------

// target = gates[gi] as an 8-way select chain, as the reference does it.
__device__ __forceinline__ void gate_target(int gi, const EnvP& P, float& tx,
                                            float& ty, float& tz) {
  tx = P.gates[0];
  ty = P.gates[1];
  tz = P.gates[2];
#pragma unroll
  for (int g = 1; g < MAX_GATES; ++g) {
    const bool sel = gi == g;
    tx = sel ? P.gates[3 * g] : tx;
    ty = sel ? P.gates[3 * g + 1] : ty;
    tz = sel ? P.gates[3 * g + 2] : tz;
  }
}

__device__ __forceinline__ void sample_waypoint(float u0, float u1, float u2,
                                                const EnvP& P, float& tx,
                                                float& ty, float& tz) {
  tx = (u0 * 2.0f - 1.0f) * P.wp_box;
  ty = (u1 * 2.0f - 1.0f) * P.wp_box;
  tz = P.wp_zmin + u2 * (P.wp_zmax - P.wp_zmin);
}

struct Fresh {
  float s[13];
  float tx, ty, tz, drm, drt;
};

// The threefry blocks env.reset_state consumes for a task: init_pose's 14
// uniforms, and the waypoint task's first target 3 more.
template <int TASK>
__host__ __device__ constexpr int fresh_blocks() {
  return TASK == TASK_WAYPOINT ? 9 : 7;
}

// Block j of episode e's reset draws as two uniforms: u[2j], u[2j + 1] of
// fresh_state. Every reset computes its blocks through this one function
// (fresh_state per lane, rollout.cu's warp passes spread over threads).
__device__ __forceinline__ void fresh_uniforms(uint32_t k0, uint32_t k1,
                                               uint32_t e, uint32_t j,
                                               float& u0, float& u1) {
  uint32_t b0, b1;
  threefry2x32(k0, k1, e, j, b0, b1);
  u0 = uniform01(b0);
  u1 = uniform01(b1);
}

// fresh_state's tail: randomize.init_pose and the task target from the
// 2 * fresh_blocks<TASK>() uniforms.
template <int TASK>
__device__ __forceinline__ void fresh_from_uniforms(const float* u,
                                                    const EnvP& P, Fresh& f) {
  f.s[0] = P.tgx + (u[0] * 2.0f - 1.0f) * P.pos_radius;
  f.s[1] = P.tgy + (u[1] * 2.0f - 1.0f) * P.pos_radius;
  f.s[2] = P.tgz + (u[2] * 2.0f - 1.0f) * P.pos_radius;
  f.s[3] = (u[3] * 2.0f - 1.0f) * P.vel_max_init;
  f.s[4] = (u[4] * 2.0f - 1.0f) * P.vel_max_init;
  f.s[5] = (u[5] * 2.0f - 1.0f) * P.vel_max_init;
  const float hx = (u[6] * 2.0f - 1.0f) * P.rot_max_init * 0.5f;
  const float hy = (u[7] * 2.0f - 1.0f) * P.rot_max_init * 0.5f;
  const float hz = (u[8] * 2.0f - 1.0f) * P.rot_max_init * 0.5f;
  const float n2 = 1.0f + (hx * hx + hy * hy + hz * hz);
  const float n = sqrtf(n2);
  f.s[6] = 1.0f / n;
  f.s[7] = hx / n;
  f.s[8] = hy / n;
  f.s[9] = hz / n;
  f.s[10] = (u[9] * 2.0f - 1.0f) * P.omega_max_init;
  f.s[11] = (u[10] * 2.0f - 1.0f) * P.omega_max_init;
  f.s[12] = (u[11] * 2.0f - 1.0f) * P.omega_max_init;
  f.drm = P.dr_mass_lo + u[12] * (P.dr_mass_hi - P.dr_mass_lo);
  f.drt = P.dr_thrust_lo + u[13] * (P.dr_thrust_hi - P.dr_thrust_lo);
  if (TASK == TASK_HOVER) {
    f.tx = P.tgx;
    f.ty = P.tgy;
    f.tz = P.tgz;
  } else if (TASK == TASK_WAYPOINT) {
    sample_waypoint(u[14], u[15], u[16], P, f.tx, f.ty, f.tz);
  } else {
    f.tx = P.gates[0];
    f.ty = P.gates[1];
    f.tz = P.gates[2];
  }
}

// env.reset_state for episode e: randomize.init_pose draws + task target.
// Computes only the threefry blocks the task consumes.
template <int TASK>
__device__ __forceinline__ void fresh_state(uint32_t k0, uint32_t k1,
                                            uint32_t e, const EnvP& P,
                                            Fresh& f) {
  constexpr int NB = fresh_blocks<TASK>();
  float u[2 * NB];
#pragma unroll
  for (int j = 0; j < NB; ++j)
    fresh_uniforms(k0, k1, e, (uint32_t)j, u[2 * j], u[2 * j + 1]);
  fresh_from_uniforms<TASK>(u, P, f);
}

// obs_matrix: the policy input of one lane (tasks.observation order).
__device__ __forceinline__ void observe(const Carry& c, float o[OBS_DIM]) {
  o[0] = c.tx - c.px;
  o[1] = c.ty - c.py;
  o[2] = c.tz - c.pz;
  o[3] = c.qw;
  o[4] = c.qx;
  o[5] = c.qy;
  o[6] = c.qz;
  o[7] = c.vx;
  o[8] = c.vy;
  o[9] = c.vz;
  o[10] = c.wx;
  o[11] = c.wy;
  o[12] = c.wz;
}

// env.step in two parts: env_advance, then env_select with a Fresh.
// env_step joins them with a reset computed on every lane; rollout.cu
// computes the reset only for the lanes that are done (warp_fresh).
//
// A step's state before the auto-reset: the integrated pose, the target
// after progression, and the waypoint and gate counters (env_advance).
struct Advance {
  float s[13];
  float tx, ty, tz;
  uint32_t wp;
  int gi;
};

// env.step up to its auto-reset: mixing, integration, reward, task
// progression and termination. Outputs the advanced state, the reward,
// done, and the pre-reset episode return and step count for accumulate().
template <int TASK, int INTEG>
__device__ __forceinline__ void env_advance(const Carry& c, float a0,
                                            float a1, float a2, float a3,
                                            const EnvP& P, Advance& v,
                                            float& r, bool& done,
                                            float& epret2, int& step2) {
  const float mass_eff = P.mass * c.drm;
  // mixing.mix
  float F[4];
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float f = (a[k] + 1.0f) * 0.5f;
    f = fminf(fmaxf(f, 0.0f), 1.0f);
    F[k] = f * P.thrust_max * c.drt;
  }
  float* s = v.s;
  s[0] = c.px; s[1] = c.py; s[2] = c.pz;
  s[3] = c.vx; s[4] = c.vy; s[5] = c.vz;
  s[6] = c.qw; s[7] = c.qx; s[8] = c.qy; s[9] = c.qz;
  s[10] = c.wx; s[11] = c.wy; s[12] = c.wz;
  integrate<INTEG>(s, F[0], F[1], F[2], F[3], mass_eff, P);

  step2 = c.stp + 1;
  // tasks.reward_base against the current (pre-progression) target
  const float dx = c.tx - s[0];
  const float dy = c.ty - s[1];
  const float dz = c.tz - s[2];
  const float d2 = dx * dx + dy * dy + dz * dz;
  r = 1.0f / (1.0f + d2);
  const float v2 = s[3] * s[3] + s[4] * s[4] + s[5] * s[5];
  r = r - P.c_vel * v2;
  const float w2 = s[10] * s[10] + s[11] * s[11] + s[12] * s[12];
  r = r - P.c_spin * w2;
  const float aa = a0 * a0 + a1 * a1 + a2 * a2 + a3 * a3;
  r = r - P.c_act * aa;

  v.tx = c.tx;
  v.ty = c.ty;
  v.tz = c.tz;
  v.wp = c.wp;
  v.gi = c.gi;
  if (TASK == TASK_WAYPOINT) {
    const bool reached = d2 < P.reach_tol2;
    r = reached ? r + P.reach_bonus : r;
    const uint32_t j0 = WP_BLOCK0 + c.wp * 2u;
    uint32_t b0, b1, b2, b3;
    threefry2x32(c.k0, c.k1, c.rc, j0, b0, b1);
    threefry2x32(c.k0, c.k1, c.rc, j0 + 1u, b2, b3);
    float ntx, nty, ntz;
    sample_waypoint(uniform01(b0), uniform01(b1), uniform01(b2), P, ntx, nty,
                    ntz);
    v.tx = reached ? ntx : c.tx;
    v.ty = reached ? nty : c.ty;
    v.tz = reached ? ntz : c.tz;
    v.wp = c.wp + (reached ? 1u : 0u);
  } else if (TASK == TASK_RACING) {
    const bool reached = d2 < P.reach_tol2;
    r = reached ? r + P.reach_bonus : r;
    const int gate_next = (c.gi + 1) % max(P.n_gates, 1);
    v.gi = reached ? gate_next : c.gi;
    gate_target(v.gi, P, v.tx, v.ty, v.tz);
    v.wp = c.wp + (reached ? 1u : 0u);
  }

  // tasks.check_crash
  const float upz = 1.0f - 2.0f * (s[7] * s[7] + s[8] * s[8]);
  bool crashed = s[2] < 0.0f;
  crashed = crashed | (upz < P.tilt_min);
  crashed = crashed | (fabsf(s[0]) > P.bound);
  crashed = crashed | (fabsf(s[1]) > P.bound);
  crashed = crashed | (s[2] > P.bound);
  const bool truncated = (step2 >= P.horizon) & !crashed;
  done = crashed | truncated;
  r = crashed ? r + P.crash_penalty : r;
  epret2 = c.epret + r;
}

// env.step's branch-free auto-reset: the carry becomes the fresh state of
// episode rc + 1 where done, else the advanced state; f's values are
// taken only where done.
__device__ __forceinline__ void env_select(Carry& c, const Advance& v,
                                           const Fresh& f, bool done,
                                           float epret2, int step2) {
  const uint32_t e2 = c.rc + 1u;
  c.px = done ? f.s[0] : v.s[0];
  c.py = done ? f.s[1] : v.s[1];
  c.pz = done ? f.s[2] : v.s[2];
  c.vx = done ? f.s[3] : v.s[3];
  c.vy = done ? f.s[4] : v.s[4];
  c.vz = done ? f.s[5] : v.s[5];
  c.qw = done ? f.s[6] : v.s[6];
  c.qx = done ? f.s[7] : v.s[7];
  c.qy = done ? f.s[8] : v.s[8];
  c.qz = done ? f.s[9] : v.s[9];
  c.wx = done ? f.s[10] : v.s[10];
  c.wy = done ? f.s[11] : v.s[11];
  c.wz = done ? f.s[12] : v.s[12];
  c.tx = done ? f.tx : v.tx;
  c.ty = done ? f.ty : v.ty;
  c.tz = done ? f.tz : v.tz;
  c.drm = done ? f.drm : c.drm;
  c.drt = done ? f.drt : c.drt;
  c.epret = done ? 0.0f : epret2;
  c.stp = done ? 0 : step2;
  c.wp = done ? 0u : v.wp;
  c.gi = done ? 0 : v.gi;
  c.rc = done ? e2 : c.rc;
}

// One env step with branch-free auto-reset (env.step): env_advance, the
// fresh state of episode rc + 1 on every lane, env_select. Outputs the
// reward, done, and the pre-reset episode return and step count for
// accumulate().
template <int TASK, int INTEG>
__device__ __forceinline__ void env_step(Carry& c, float a0, float a1,
                                         float a2, float a3, const EnvP& P,
                                         float& r, bool& done, float& epret2,
                                         int& step2) {
  Advance v;
  env_advance<TASK, INTEG>(c, a0, a1, a2, a3, P, v, r, done, epret2, step2);
  Fresh f;
  fresh_state<TASK>(c.k0, c.k1, c.rc + 1u, P, f);
  env_select(c, v, f, done, epret2, step2);
}

// Per-lane episode statistics (pallas_rollout.accumulate).
__device__ __forceinline__ void accumulate(float acc[N_STATS], float r,
                                           bool done, float epret2,
                                           int step2) {
  const float donef = done ? 1.0f : 0.0f;
  const float ep_ret = done ? epret2 : 0.0f;
  acc[0] = acc[0] + r;
  acc[1] = acc[1] + donef;
  acc[2] = acc[2] + ep_ret;
  acc[3] = acc[3] + donef * (float)step2;
  acc[4] = acc[4] + ep_ret * ep_ret;
}

// Structure-of-arrays state planes in device memory, each of length n.
struct Planes {
  const float* fs;     // (NF, n)
  const uint32_t* us;  // (NU, n)
  const int* st;       // (NI, n)
  float* ofs;
  uint32_t* ous;
  int* ost;
  float* stats;        // (N_STATS, n)
  int n;
};

__device__ __forceinline__ Carry read_carry(const Planes& p, int i) {
  const int n = p.n;
  Carry c;
  c.px = p.fs[0 * n + i];  c.py = p.fs[1 * n + i];  c.pz = p.fs[2 * n + i];
  c.vx = p.fs[3 * n + i];  c.vy = p.fs[4 * n + i];  c.vz = p.fs[5 * n + i];
  c.qw = p.fs[6 * n + i];  c.qx = p.fs[7 * n + i];  c.qy = p.fs[8 * n + i];
  c.qz = p.fs[9 * n + i];  c.wx = p.fs[10 * n + i]; c.wy = p.fs[11 * n + i];
  c.wz = p.fs[12 * n + i]; c.tx = p.fs[13 * n + i]; c.ty = p.fs[14 * n + i];
  c.tz = p.fs[15 * n + i]; c.drm = p.fs[16 * n + i];
  c.drt = p.fs[17 * n + i]; c.epret = p.fs[18 * n + i];
  c.rc = p.us[0 * n + i];  c.k0 = p.us[1 * n + i];
  c.k1 = p.us[2 * n + i];  c.wp = p.us[3 * n + i];
  c.stp = p.st[0 * n + i]; c.gi = p.st[1 * n + i];
  return c;
}

__device__ __forceinline__ void write_back(const Planes& p, int i,
                                           const Carry& c,
                                           const float acc[N_STATS]) {
  const int n = p.n;
  p.ofs[0 * n + i] = c.px;  p.ofs[1 * n + i] = c.py;  p.ofs[2 * n + i] = c.pz;
  p.ofs[3 * n + i] = c.vx;  p.ofs[4 * n + i] = c.vy;  p.ofs[5 * n + i] = c.vz;
  p.ofs[6 * n + i] = c.qw;  p.ofs[7 * n + i] = c.qx;  p.ofs[8 * n + i] = c.qy;
  p.ofs[9 * n + i] = c.qz;  p.ofs[10 * n + i] = c.wx; p.ofs[11 * n + i] = c.wy;
  p.ofs[12 * n + i] = c.wz; p.ofs[13 * n + i] = c.tx; p.ofs[14 * n + i] = c.ty;
  p.ofs[15 * n + i] = c.tz; p.ofs[16 * n + i] = c.drm;
  p.ofs[17 * n + i] = c.drt; p.ofs[18 * n + i] = c.epret;
  p.ous[0 * n + i] = c.rc;  p.ous[1 * n + i] = c.k0;
  p.ous[2 * n + i] = c.k1;  p.ous[3 * n + i] = c.wp;
  p.ost[0 * n + i] = c.stp; p.ost[1 * n + i] = c.gi;
#pragma unroll
  for (int k = 0; k < N_STATS; ++k) p.stats[k * n + i] = acc[k];
}

}  // namespace drone
