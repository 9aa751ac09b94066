"""MLP acting megakernel (K5): policy tower + env step, T steps per launch.

Counterpart of `drone_tpu/ops/pallas_acting.py`; evaluate()'s path. The
kernel is `csrc/acting.cu`; `act_rollout_plain` is its plain PyTorch
version (the module's actor tower, then the batched env step, with the
same per-lane statistics as `cuda_rollout`). `act_rollout_cuda` takes the
plain version for CPU tensors only; on a CUDA tensor it launches the kernel.

Two action modes, as in the reference:
  - deterministic (default): action = the policy mean;
  - stochastic=True: action = mean + exp(log_std) * z, z ~ N(0, 1) from a
    Box-Muller transform over the lane's threefry stream at blocks
    NOISE_BLOCK0 + 2*step (+1).

The kernel sums the tower in another order than a matmul and takes tanh,
log, sin and cos from CUDA's libdevice, so it agrees with the plain version
to a tolerance, not bitwise; the env step inside stays bitwise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch import prng
from drone_tpu_torch.dynamics import sqrt_rn
from drone_tpu_torch.models.mlp import ActorCritic
from drone_tpu_torch.ops import cuda_build
from drone_tpu_torch.ops.cuda_rollout import (
    N_STATS,
    accumulate,
    check_cuda_state,
    launch_planes,
    stats_dict,
)
from drone_tpu_torch.types import (
    OBS_DIM,
    EnvParams,
    EnvState,
    EnvStatics,
)

NOISE_BLOCK0 = 0x60000000  # exploration-noise stream (disjoint from the
                           # action, reset and waypoint blocks)
_TWO_PI = 6.2831853071795864

# kernel limits (csrc/acting.cu)
MAX_HIDDEN = 8
MAX_WIDTH = 256
_CHUNK = 16
_THREADS = 128
# dynamic shared memory one H100 block can use: 232,448 bytes less the
# static copy of the env params
_MAX_SMEM = 232448 - 256


def gauss4(state: EnvState) -> torch.Tensor:
    """(N, 4) standard normals from blocks NOISE_BLOCK0 + 2*step (+1) of
    each lane's current episode (pallas_acting._gauss4_planes)."""
    jb = NOISE_BLOCK0 + 2 * prng.to_u32(state.step)
    k0, k1, rc = state.key0, state.key1, state.reset_count
    b0, b1 = prng.threefry2x32(k0, k1, rc, jb)
    b2, b3 = prng.threefry2x32(k0, k1, rc, jb + 1)
    u1, u2, u3, u4 = (prng.bits_to_uniform(b) for b in (b0, b1, b2, b3))
    # 1-u in (0, 1]: log never sees 0
    r1 = sqrt_rn(-2.0 * torch.log(1.0 - u1))
    r2 = sqrt_rn(-2.0 * torch.log(1.0 - u3))
    a1 = _TWO_PI * u2
    a2 = _TWO_PI * u4
    return torch.stack([r1 * torch.cos(a1), r1 * torch.sin(a1),
                        r2 * torch.cos(a2), r2 * torch.sin(a2)], 1)


def act_rollout_plain(state: EnvState, policy: ActorCritic,
                      env_params: EnvParams, statics: EnvStatics, T: int,
                      stochastic: bool = False):
    """Plain PyTorch version of the kernel. Returns (final EnvState,
    per-lane statistics (N_STATS, N))."""
    # a float32 matmul in full precision on the card (the default; stated
    # because a TF32 tower would differ from the kernel by far more)
    torch.backends.cuda.matmul.allow_tf32 = False
    std = torch.exp(policy.log_std.detach())
    acc = torch.zeros(N_STATS, state.n, device=state.pos.device)
    with torch.no_grad():
        for _ in range(T):
            a = policy.actor(env_mod.observe(state))
            if stochastic:
                a = a + std * gauss4(state)
            state, out = env_mod.step(state, a, env_params, statics)
            acc = accumulate(acc, out)
    return state, acc


def tower_layout(widths, n_head: int = 4):
    """policy.cuh's shared-memory layout of one tower: each hidden layer as
    W^T (in, out padded to 16) then its padded bias, then the head as W^T
    (in, n_head) and its bias. Returns (the Tower ints [n_hidden, head_off,
    n_weights, maxw_p, width[MAX_HIDDEN], off[MAX_HIDDEN]] as int32, the
    per-layer offsets). n_weights is rounded up to a multiple of 4 floats.
    Raises for a tower the kernels cannot take."""
    widths = [int(w) for w in widths]
    if len(widths) > MAX_HIDDEN or any(w > MAX_WIDTH for w in widths):
        raise ValueError(f"the acting kernels take at most {MAX_HIDDEN} "
                         f"hidden layers of width <= {MAX_WIDTH}, got {widths}")
    offs, off, nin = [], 0, OBS_DIM
    for w in widths:
        offs.append(off)
        off += (nin + 1) * _pad16(w)
        nin = w
    head_off = off
    off += (nin + 1) * n_head
    ints = np.zeros(4 + 2 * MAX_HIDDEN, np.int32)
    ints[:4] = (len(widths), head_off, -(-off // 4) * 4,
                max((_pad16(w) for w in widths), default=0))
    ints[4:4 + len(widths)] = widths
    ints[4 + MAX_HIDDEN:4 + MAX_HIDDEN + len(widths)] = offs
    return ints, offs


def check_smem(n_weights: int, widths) -> None:
    """Raise when the weights and the activation columns of one block do
    not fit its shared memory."""
    maxw = max((_pad16(w) for w in widths), default=0)
    n_buf = 2 if len(widths) >= 3 else (1 if len(widths) == 2 else 0)
    smem = 4 * (n_weights + (_CHUNK + n_buf * maxw) * _THREADS)
    if smem > _MAX_SMEM:
        raise ValueError(f"towers {list(widths)} need {smem} bytes of shared "
                         f"memory per block; the kernels have {_MAX_SMEM}")


def check_envelope(widths) -> None:
    """Raise ValueError for an actor tower the acting kernel cannot take
    (tower_layout's limits and a block's shared memory). evaluate() asks
    this before it picks K5."""
    layout, _ = tower_layout(widths)
    check_smem(int(layout[2]), widths)


def _pad16(w: int) -> int:
    return -(-w // _CHUNK) * _CHUNK


def pack_tower(policy: ActorCritic, device):
    """The actor tower in the kernel's shared-memory layout (`tower_layout`)
    in one float32 buffer. Returns (buffer, layout int32 array, std float32
    array)."""
    widths = [lin.out_features for lin in policy.hidden_layers("actor")]
    layout, offs = tower_layout(widths)
    parts, nin = [], OBS_DIM
    with torch.no_grad():
        for lin in policy.hidden_layers("actor"):
            blk = torch.zeros(nin + 1, _pad16(lin.out_features), device=device)
            blk[:nin, :lin.out_features] = lin.weight.t()
            blk[nin, :lin.out_features] = lin.bias
            parts.append(blk.reshape(-1))
            nin = lin.out_features
        parts += [policy.actor_mean.weight.t().reshape(-1).to(device),
                  policy.actor_mean.bias.to(device)]
        weights = torch.cat(parts).to(torch.float32).contiguous()
    assert weights.numel() == layout[2]
    check_envelope(widths)
    std = np.ascontiguousarray(
        torch.exp(policy.log_std.detach()).cpu().numpy(), np.float32)
    return weights, layout, std


def act_rollout_kernel(state: EnvState, policy: ActorCritic,
                       env_params: EnvParams, statics: EnvStatics, T: int,
                       stochastic: bool = False):
    """Launch csrc/acting.cu. Same contract as act_rollout_plain."""
    check_cuda_state(state)
    weights, layout, std = pack_tower(policy, state.pos.device)
    fn = cuda_build.load("acting").drone_act_rollout
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    out = launch_planes(fn, state, env_params, statics, T, weights.data_ptr(),
                        layout.ctypes.data, std.ctypes.data, int(stochastic))
    act_rollout_cuda.launches += 1
    return out


def act_rollout_cuda(state: EnvState, policy: ActorCritic,
                     env_params: EnvParams, statics: EnvStatics, T: int,
                     stochastic: bool = False):
    """Run T policy+env steps per lane: the kernel on a CUDA state, the
    plain version on a CPU state. policy: an ActorCritic (float32), any
    depth of actor_h{i}. Returns (final EnvState, stats dict) — the
    contract of cuda_rollout.rollout_cuda."""
    run = (act_rollout_plain if state.pos.device.type == "cpu"
           else act_rollout_kernel)
    final, lane_stats = run(state, policy, env_params, statics, T, stochastic)
    return final, stats_dict(lane_stats)


act_rollout_cuda.launches = 0
