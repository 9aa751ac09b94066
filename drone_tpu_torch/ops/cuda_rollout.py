"""Env megakernel (K1): T env steps per lane in one launch.

Counterpart of `drone_tpu/ops/pallas_rollout.py`. The kernel is
`csrc/rollout.cu` (device functions in `csrc/env.cuh`); `rollout_plain` is
its plain PyTorch version, the batched env of `drone_tpu_torch.env` stepped
T times with the same per-lane statistics. `rollout_cuda` takes the plain
version for CPU tensors only; on a CUDA tensor it launches the kernel.

Two action sources, as in the reference:
  - actions=None: uniform actions in [-1, 1] from the lane's threefry
    stream at block ACTION_BLOCK0 + 2*step (step = the lane's carried
    episode-step counter, so chained calls never reuse a counter);
  - actions=(T, N, 4) float32: a provided stream.

Both versions return (final EnvState, per-lane statistics (N_STATS, N)):
reward, episodes, ep_return, ep_length and ep_return^2 summed over the
steps of each lane, in the same order, so the kernel's planes equal the
plain version's bitwise. `rollout_cuda` reduces them with torch.sum.
"""

from __future__ import annotations

import ctypes

import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch import prng
from drone_tpu_torch.ops import cuda_build
from drone_tpu_torch.types import (
    MAX_GATES,
    EnvParams,
    EnvState,
    EnvStatics,
)

NF = 19   # f32 planes: pos vel quat omega target dr_mass dr_thrust ep_return
NU = 4    # u32 planes: reset_count key0 key1 wp_count
NI = 2    # i32 planes: step gate_idx
N_STATS = 5  # reward, episodes, ep_return, ep_length, ep_return^2
ACTION_BLOCK0 = 0x40000000

# f32 scalar params in kernel order (csrc/env.cuh EnvP), then target, gates
_PF = ("mass", "gravity", "arm_l", "thrust_max", "torque_coef",
       "inertia_x", "inertia_y", "inertia_z", "drag_lin", "drag_ang", "dt",
       "bound", "tilt_min", "c_vel", "c_spin", "c_act", "crash_penalty",
       "reach_bonus", "reach_tol2",
       "pos_radius", "vel_max_init", "rot_max_init", "omega_max_init",
       "dr_mass_lo", "dr_mass_hi", "dr_thrust_lo", "dr_thrust_hi",
       "wp_box", "wp_zmin", "wp_zmax")
NPF = len(_PF) + 3 + 3 * MAX_GATES


def pack_params(p: EnvParams, device):
    """Kernel param buffers on `device`: (pf (NPF,) float32, pi (2,) int32)
    in csrc/env.cuh EnvP order. No host round trip, so no sync."""
    pf = torch.cat([torch.stack([getattr(p, k) for k in _PF]),
                    p.target.reshape(3), p.gates.reshape(3 * MAX_GATES)])
    pi = torch.stack([p.horizon, p.n_gates])
    return (pf.to(device=device, dtype=torch.float32).contiguous(),
            pi.to(device=device, dtype=torch.int32).contiguous())


def pack_state(s: EnvState):
    """EnvState -> (fs (NF, N) f32, us (NU, N) i32 bits, st (NI, N) i32)."""
    fs = s.fstate().t().contiguous()
    us = torch.stack([s.reset_count, s.key0, s.key1, s.wp_count])
    st = torch.stack([s.step, s.gate_idx])
    return fs, us, st


def unpack_state(fs, us, st) -> EnvState:
    """Inverse of pack_state."""
    return EnvState(
        pos=fs[0:3].t(), vel=fs[3:6].t(), quat=fs[6:10].t(),
        omega=fs[10:13].t(), target=fs[13:16].t(),
        dr_mass=fs[16], dr_thrust=fs[17], ep_return=fs[18],
        step=st[0], reset_count=us[0], wp_count=us[3], gate_idx=st[1],
        key0=us[1], key1=us[2],
    )


def accumulate(acc, out):
    """Add one step's StepOut to the per-lane statistics (N_STATS, N), in
    the kernel's order (pallas_rollout.accumulate)."""
    done = out.terminated | out.truncated
    donef = done.to(torch.float32)
    ep_ret = out.ep_return
    return torch.stack([acc[0] + out.reward,
                        acc[1] + donef,
                        acc[2] + ep_ret,
                        acc[3] + donef * out.ep_length.to(torch.float32),
                        acc[4] + ep_ret * ep_ret])


def random_actions(state: EnvState) -> torch.Tensor:
    """The in-kernel action stream: 4 uniforms in [-1, 1) per lane from
    blocks ACTION_BLOCK0 + 2*step (+1) of the lane's current episode."""
    jb = ACTION_BLOCK0 + 2 * prng.to_u32(state.step)
    k0, k1, rc = state.key0, state.key1, state.reset_count
    b0, b1 = prng.threefry2x32(k0, k1, rc, jb)
    b2, b3 = prng.threefry2x32(k0, k1, rc, jb + 1)
    return torch.stack([prng.bits_to_uniform(b) * 2.0 - 1.0
                        for b in (b0, b1, b2, b3)], 1)


def rollout_plain(state: EnvState, params: EnvParams, statics: EnvStatics,
                  T: int, actions=None):
    """Plain PyTorch version of the kernel: T batched env steps."""
    acc = torch.zeros(N_STATS, state.n, device=state.pos.device)
    for t in range(T):
        a = random_actions(state) if actions is None else actions[t]
        state, out = env_mod.step(state, a, params, statics)
        acc = accumulate(acc, out)
    return state, acc


def _check_actions(actions, n, T, device):
    if actions is None:
        return None
    if (actions.shape != (T, n, 4) or actions.dtype != torch.float32
            or actions.device != device):
        raise ValueError(f"actions must be float32 (T={T}, N={n}, 4) on "
                         f"{device}, got {tuple(actions.shape)} "
                         f"{actions.dtype} on {actions.device}")
    return actions.contiguous()


def check_cuda_state(state: EnvState):
    if state.pos.device.type != "cuda":
        raise ValueError("the kernel runs on CUDA tensors only")
    if state.pos.dtype != torch.float32:
        raise ValueError("state must be float32")


def launch_planes(fn, state: EnvState, params: EnvParams,
                  statics: EnvStatics, T: int, *extra):
    """Call a kernel entry point with the C signature shared by the rollout
    kernels: (pf, pi, fs, us, st, ofs, ous, ost, stats, *extra, n, T, task,
    integrator, stream). Packs the state and params, allocates the outputs,
    launches on the current stream of the state's device and raises on a
    launch error. Returns (final EnvState, per-lane statistics)."""
    fs, us, st = pack_state(state)
    pf, pi = pack_params(params, fs.device)
    ofs, ous, ost = torch.empty_like(fs), torch.empty_like(us), torch.empty_like(st)
    stats = torch.empty(N_STATS, state.n, dtype=torch.float32, device=fs.device)
    fn.restype = ctypes.c_int
    with torch.cuda.device(fs.device):
        err = fn(pf.data_ptr(), pi.data_ptr(), fs.data_ptr(), us.data_ptr(),
                 st.data_ptr(), ofs.data_ptr(), ous.data_ptr(), ost.data_ptr(),
                 stats.data_ptr(), *extra, state.n, T, statics.task_id,
                 statics.integrator_id,
                 torch.cuda.current_stream(fs.device).cuda_stream)
    cuda_build.check(err, fn.__name__)
    return unpack_state(ofs, ous, ost), stats


def rollout_kernel(state: EnvState, params: EnvParams, statics: EnvStatics,
                   T: int, actions=None):
    """Launch csrc/rollout.cu. Same contract as rollout_plain."""
    check_cuda_state(state)
    actions = _check_actions(actions, state.n, T, state.pos.device)
    fn = cuda_build.load("rollout").drone_rollout
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    out = launch_planes(fn, state, params, statics, T,
                        None if actions is None else actions.data_ptr())
    rollout_cuda.launches += 1
    return out


def stats_dict(lane_stats: torch.Tensor) -> dict:
    s = torch.sum(lane_stats, dim=1)
    return {"reward_sum": s[0], "episodes": s[1], "ep_return_sum": s[2],
            "ep_length_sum": s[3], "ep_return_sq_sum": s[4]}


def rollout_cuda(state: EnvState, params: EnvParams, statics: EnvStatics,
                 T: int, actions=None):
    """Run T env steps per lane (any task, any integrator): the kernel on a
    CUDA state, the plain version on a CPU state.
    Returns (final EnvState, stats dict with reward_sum / episodes /
    ep_return_sum / ep_length_sum / ep_return_sq_sum)."""
    run = rollout_plain if state.pos.device.type == "cpu" else rollout_kernel
    final, lane_stats = run(state, params, statics, T, actions)
    return final, stats_dict(lane_stats)


rollout_cuda.launches = 0
