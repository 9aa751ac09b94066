"""Trajectory rollout kernel (K2): actor + critic + noise + env step.

Counterpart of `drone_tpu/ops/pallas_acting_traj.py`; the megakernel
trainer's rollout. The kernel is `csrc/acting_traj.cu`; `traj_rollout_plain`
is its plain PyTorch version (observe -> both towers -> gauss4 ->
`sample_logp` -> env step, T times). `traj_rollout_cuda` takes the plain
version for CPU tensors only; on a CUDA tensor it launches the kernel.

Both return (final EnvState, training planes (T, N_TRAJ, N) float32, stats
dict): the planes are obs(13) action(4) logp value reward done per lane and
step, in the reference's TP_* order and its kernel-natural time-major
layout (its (T, 21, rows, 128) with the lane axis flattened). The policy is
the trainer's flat parameter buffer (`ActorCritic.flatten_`, kernel order)
and its hidden widths; the kernel reads log_std from it on the device.

Exploration noise comes from the lane's counter stream (blocks NOISE_BLOCK0
+ 2*step), as in the reference. The log-prob is rebuilt from the stored
action, so the first PPO minibatch sees ratio == 1.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch.nn import functional as F

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.models.mlp import kernel_offsets
from drone_tpu_torch.ops import cuda_build
from drone_tpu_torch.ops.cuda_acting import (
    MAX_HIDDEN,
    check_smem,
    gauss4,
    tower_layout,
)
from drone_tpu_torch.ops.cuda_rollout import (
    N_STATS,
    accumulate,
    check_cuda_state,
    launch_planes,
    stats_dict,
)
from drone_tpu_torch.types import OBS_DIM, EnvParams, EnvState, EnvStatics

# trajectory plane layout (f32), pallas_acting_traj.TP_*
TP_OBS0 = 0
TP_ACT0 = OBS_DIM
TP_LOGP = OBS_DIM + 4
TP_VAL = OBS_DIM + 5
TP_REW = OBS_DIM + 6
TP_DONE = OBS_DIM + 7
N_TRAJ = OBS_DIM + 8       # 21

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def tower_weights(theta: torch.Tensor, hidden):
    """Views of the flat buffer: ([(W (out, in), b (out,)), ...] of the
    actor, the same of the critic, log_std (4,))."""
    offs, total = kernel_offsets(hidden)
    if theta.shape != (total,):
        raise ValueError(f"flat parameters of {list(hidden)} have {total} "
                         f"floats, got shape {tuple(theta.shape)}")
    fan = [OBS_DIM, *hidden]

    def layer(name, nout, nin):
        w0, b0 = offs[f"{name}.weight"], offs[f"{name}.bias"]
        return (theta[w0:w0 + nout * nin].view(nout, nin),
                theta[b0:b0 + nout])

    towers = []
    for tower, head, nh in (("actor", "actor_mean", 4),
                            ("critic", "critic_value", 1)):
        ws = [layer(f"{tower}_h{i}", h, fan[i]) for i, h in enumerate(hidden)]
        ws.append(layer(head, nh, fan[-1]))
        towers.append(ws)
    ls = theta[offs["log_std"]:offs["log_std"] + 4]
    return towers[0], towers[1], ls


def tower_forward(x, weights):
    """(S, in) -> (S, out): tanh hidden layers, linear head (_tower)."""
    for li, (w, b) in enumerate(weights):
        x = F.linear(x, w, b)
        if li < len(weights) - 1:
            x = torch.tanh(x)
    return x


def sample_logp(m, z, ls, stochastic: bool):
    """_sample_logp: (action (N, 4), logp (N,)) from means m (N, 4), noise
    z (N, 4) and log_std (4,); logp is rebuilt from the stored action."""
    std = torch.exp(ls)
    a = m + std * z if stochastic else m
    zr = (a - m) / std
    lp = -0.5 * (zr * zr) - ls - HALF_LOG_2PI
    logp = ((lp[:, 0] + lp[:, 1]) + lp[:, 2]) + lp[:, 3]
    return a, logp


@torch.no_grad()
def traj_rollout_plain(state: EnvState, theta: torch.Tensor, hidden,
                       env_params: EnvParams, statics: EnvStatics, T: int,
                       stochastic: bool = True):
    """Plain PyTorch version of the kernel. Returns (final EnvState, planes
    (T, N_TRAJ, N), per-lane statistics (N_STATS, N))."""
    # full float32 matmuls on the card (the default, stated: TF32 would
    # differ from the kernel by far more than its tolerance)
    torch.backends.cuda.matmul.allow_tf32 = False
    actor, critic, ls = tower_weights(theta, hidden)
    dev = state.pos.device
    planes = torch.empty(T, N_TRAJ, state.n, device=dev)
    acc = torch.zeros(N_STATS, state.n, device=dev)
    for t in range(T):
        obs = env_mod.observe(state)
        m = tower_forward(obs, actor)
        v = tower_forward(obs, critic)[:, 0]
        z = gauss4(state) if stochastic else torch.zeros_like(m)
        a, logp = sample_logp(m, z, ls, stochastic)
        state, out = env_mod.step(state, a, env_params, statics)
        done = (out.terminated | out.truncated).to(torch.float32)
        planes[t] = torch.cat([obs.t(), a.t(), logp[None], v[None],
                               out.reward[None], done[None]])
        acc = accumulate(acc, out)
    return state, planes, acc


def kernel_layout(hidden) -> np.ndarray:
    """The host ints of drone_traj_rollout: per tower (actor, critic) the
    Tower ints of `cuda_acting.tower_layout` then MAX_HIDDEN + 1 layer
    offsets into the flat buffer, then log_std's offset. Raises for a tower
    the kernel cannot take."""
    hidden = tuple(int(h) for h in hidden)
    offs, _ = kernel_offsets(hidden)
    parts, n_weights = [], 0
    for tower, head, nh in (("actor", "actor_mean", 4),
                            ("critic", "critic_value", 1)):
        ints, _ = tower_layout(hidden, nh)
        src = np.zeros(MAX_HIDDEN + 1, np.int32)
        names = [f"{tower}_h{i}" for i in range(len(hidden))] + [head]
        src[:len(names)] = [offs[f"{name}.weight"] for name in names]
        parts += [ints, src]
        n_weights += int(ints[2])
    parts.append(np.array([offs["log_std"]], np.int32))
    check_smem(n_weights, hidden)
    return np.ascontiguousarray(np.concatenate(parts), np.int32)


def traj_rollout_kernel(state: EnvState, theta: torch.Tensor, hidden,
                        env_params: EnvParams, statics: EnvStatics, T: int,
                        stochastic: bool = True):
    """Launch csrc/acting_traj.cu. Same contract as traj_rollout_plain."""
    check_cuda_state(state)
    tower_weights(theta, hidden)  # checks the buffer's length
    if (theta.device != state.pos.device or theta.dtype != torch.float32
            or not theta.is_contiguous()):
        raise ValueError("theta must be a contiguous float32 buffer on the "
                         "state's device")
    layout = kernel_layout(hidden)
    planes = torch.empty(T, N_TRAJ, state.n, device=state.pos.device)
    fn = cuda_build.load("acting_traj").drone_traj_rollout
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    final, lane_stats = launch_planes(
        fn, state, env_params, statics, T, planes.data_ptr(),
        theta.data_ptr(), layout.ctypes.data, int(stochastic))
    traj_rollout_cuda.launches += 1
    return final, planes, lane_stats


def traj_rollout_cuda(state: EnvState, theta: torch.Tensor, hidden,
                      env_params: EnvParams, statics: EnvStatics, T: int,
                      stochastic: bool = True):
    """T policy+env steps per lane emitting the PPO training planes: the
    kernel on a CUDA state, the plain version on a CPU state. Returns
    (final EnvState, planes (T, N_TRAJ, N), stats dict)."""
    run = (traj_rollout_plain if state.pos.device.type == "cpu"
           else traj_rollout_kernel)
    final, planes, lane_stats = run(state, theta, hidden, env_params, statics,
                                    T, stochastic)
    return final, planes, stats_dict(lane_stats)


traj_rollout_cuda.launches = 0
