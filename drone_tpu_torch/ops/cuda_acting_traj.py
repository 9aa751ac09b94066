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

The kernel runs both towers' products on the tensor cores in 3xTF32 (the
weights split on the device from the flat buffer, `traj_layout`) and takes
tanh, exp, log, sin and cos from CUDA's libdevice, so it agrees with the
plain version to a tolerance, not bitwise; the env step inside stays
bitwise. Its envelope is the fp32 kernel's it replaced (`check_envelope`).

`compute_dtype="bfloat16"` is the reference's bf16 operand arm: every
product of the towers takes its operands rounded to bfloat16 (`operand`,
the reference's `_dot32`) and sums in float32, so the outputs stay
float32. The kernel's bf16 arm stores its rows once as bf16 and runs the
bf16 tensor cores' m16n8k16 product on them and on bf16x2 weight
fragments (`layout_at(..., bf16=True)`); the plain version rounds the
same operands.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
from torch.nn import functional as F

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.models.mlp import kernel_offsets
from drone_tpu_torch.ops import cuda_build
from drone_tpu_torch.ops.cuda_acting import (
    ACT_OBS_ROWS,
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

TRAJ_MAX_LANES = 512       # the kernel's lanes a block at most
# dynamic shared memory one H100 block can use, less the env params' copy
_MAX_SMEM = 232448 - 256

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
COMPUTE_DTYPES = ("float32", "bfloat16")


def bf16_flag(compute_dtype: str) -> int:
    """1 for the kernels' bf16 operand arm, 0 for float32 (3xTF32); raises
    ValueError for another compute dtype."""
    if compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {COMPUTE_DTYPES}, "
                         f"got {compute_dtype!r}")
    return int(compute_dtype == "bfloat16")


def operand(x, compute_dtype: str = "float32"):
    """An operand of a tower product as the reference's `_dot32` takes it:
    under bfloat16 rounded to bfloat16 (nearest even) and widened back to
    float32, so the product is exact and sums in float32 (a bfloat16 matmul
    would round its output too); under float32 x itself."""
    if bf16_flag(compute_dtype):
        return x.to(torch.bfloat16).to(torch.float32)
    return x


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


def tower_forward(x, weights, compute_dtype: str = "float32"):
    """(S, in) -> (S, out): tanh hidden layers, linear head (_tower), each
    product's operands as `operand` takes them."""
    for li, (w, b) in enumerate(weights):
        x = F.linear(operand(x, compute_dtype), operand(w, compute_dtype), b)
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
                       stochastic: bool = True,
                       compute_dtype: str = "float32"):
    """Plain PyTorch version of the kernel. Returns (final EnvState, planes
    (T, N_TRAJ, N), per-lane statistics (N_STATS, N))."""
    # full float32 matmuls on the card (the default, stated: TF32 would
    # differ from the kernel by far more than its tolerance)
    torch.backends.cuda.matmul.allow_tf32 = False
    actor, critic, ls = tower_weights(theta, hidden)
    # under float32 the module's tower_forward as it is: the hook an
    # emulation of the kernel's 3xTF32 products takes
    towers = (functools.partial(tower_forward, compute_dtype=compute_dtype)
              if bf16_flag(compute_dtype) else tower_forward)
    dev = state.pos.device
    planes = torch.empty(T, N_TRAJ, state.n, device=dev)
    acc = torch.zeros(N_STATS, state.n, device=dev)
    for t in range(T):
        obs = env_mod.observe(state)
        m = towers(obs, actor)
        v = towers(obs, critic)[:, 0]
        z = gauss4(state) if stochastic else torch.zeros_like(m)
        a, logp = sample_logp(m, z, ls, stochastic)
        state, out = env_mod.step(state, a, env_params, statics)
        done = (out.terminated | out.truncated).to(torch.float32)
        planes[t] = torch.cat([obs.t(), a.t(), logp[None], v[None],
                               out.reward[None], done[None]])
        acc = accumulate(acc, out)
    return state, planes, acc


def check_envelope(hidden) -> None:
    """Raise ValueError for towers K2 does not take: the envelope of the
    fp32 kernel it replaced (both towers' weights, W^T with outputs padded
    to 16, and a 128-lane block's activation columns in one block's shared
    memory; `cuda_acting.tower_layout` and `check_smem`), so that
    train.build routes every tower as before. The tensor-core kernel takes
    every one of them (traj_layout)."""
    n_weights = 0
    for n_head in (4, 1):
        ints, _ = tower_layout(hidden, n_head)
        n_weights += int(ints[2])
    check_smem(n_weights, hidden)


def _up8(w: int) -> int:
    return -(-w // 8) * 8


def _up16(w: int) -> int:
    return -(-w // 16) * 16


def layout_at(hidden, lanes: int, wsm: int, bf16: bool = False) -> dict | None:
    """csrc/acting_traj.cu's `make_traj_layout` and `traj_smem` for towers
    of hidden `hidden` at `lanes` a block (`bl`, a multiple of 32 up to
    TRAJ_MAX_LANES), both towers' fragments staged in shared memory (`wsm`
    1) or read through L1 (0), or None when that does not fit a block: per
    layer (the head last, 8 outputs) its widths, its packed fragments'
    float4 offset `fo` and its padded bias's `bo`, both relative to its
    tower; a tower's fragment float4s `f4` and bias floats `nb`; the
    packed buffer's floats `wfl`; the shared floats before the fragments
    `hf` (log_std, std, both towers' biases); the activation rows (obs,
    ping `ha`, pong `hb`, `rows` in all, stride bl + 8); the dynamic shared
    memory `smem`. `ints` are the kernel's layout ints [n_hidden, bl, wsm,
    smem, wfl, width[MAX_HIDDEN], the actor's layer offsets into the flat
    buffer[MAX_HIDDEN + 1], the critic's[MAX_HIDDEN + 1], log_std's
    offset]. With bf16 the bf16 arm's: `fo` counts uint2 fragments of
    m16n8k16 (a layer's inputs padded to 16), `f4` the 16-byte units a
    tower's take, the stored layers' rows are padded to 16 and hold
    bf16."""
    hidden = tuple(int(h) for h in hidden)
    L = len(hidden)
    layers, fo, bo, nin, mw = [], 0, 0, OBS_DIM, 0
    for li in range(L + 1):
        nout = hidden[li] if li < L else 8
        layers.append({"nin": nin, "nout": nout, "fo": fo, "bo": bo})
        fo += (_up16(nin) * _up8(nout) // 4 if bf16
               else _up8(nin) * _up8(nout) // 2)
        bo += _up8(nout)
        if li + 2 <= L:
            mw = max(mw, _up16(nout) if bf16 else _up8(nout))
        nin = nout
    f4 = fo // 2 if bf16 else fo
    wfl = -(-(8 * f4 + 2 * bo) // 4) * 4
    hf = -(-(8 + 2 * bo) // 4) * 4
    rows = ACT_OBS_ROWS + (mw if L >= 2 else 0) + (mw if L >= 3 else 0)
    smem = 4 * (hf + wsm * 8 * f4) + (2 if bf16 else 4) * rows * (lanes + 8)
    if (smem > _MAX_SMEM or lanes % 32 or not 32 <= lanes <= TRAJ_MAX_LANES
            or wsm not in (0, 1)):
        return None
    offs, _ = kernel_offsets(hidden)
    ints = np.zeros(6 + 3 * MAX_HIDDEN + 2, np.int32)
    ints[:5] = (L, lanes, wsm, smem, wfl)
    ints[5:5 + L] = hidden
    for t, (tower, head) in enumerate((("actor", "actor_mean"),
                                        ("critic", "critic_value"))):
        names = [f"{tower}_h{i}" for i in range(L)] + [head]
        at = 5 + MAX_HIDDEN + t * (MAX_HIDDEN + 1)
        ints[at:at + L + 1] = [offs[f"{name}.weight"] for name in names]
    ints[-1] = offs["log_std"]
    return {"ints": ints, "layers": layers, "f4": f4, "nb": bo, "wfl": wfl,
            "hf": hf, "ha": ACT_OBS_ROWS, "hb": ACT_OBS_ROWS + (
                mw if L >= 3 else 0), "rows": rows, "bl": lanes, "wsm": wsm,
            "smem": smem}


def traj_layout(hidden, compute_dtype: str = "float32") -> dict:
    """K2's layout (`layout_at`; its bf16 arm's under bfloat16) for towers
    of hidden `hidden`: the most lanes a block whose rows fit, the
    fragments staged when they fit beside them. At [64, 64] that is 512
    lanes, one wave of 65,536 lanes, the fragments through L1 (the bf16
    arm's rows, half the bytes, leave room to stage them): staging them
    leaves room for 256 lanes, two waves, 20% slower (PERF.md). Raises for
    towers the kernel cannot take."""
    check_envelope(hidden)
    bf16 = bool(bf16_flag(compute_dtype))
    for lanes in range(TRAJ_MAX_LANES, 31, -32):
        for wsm in (1, 0):
            lay = layout_at(hidden, lanes, wsm, bf16)
            if lay is not None:
                return lay
    raise ValueError(f"towers {list(hidden)}: no block of 32 lanes fits")


def traj_rollout_kernel(state: EnvState, theta: torch.Tensor, hidden,
                        env_params: EnvParams, statics: EnvStatics, T: int,
                        stochastic: bool = True,
                        compute_dtype: str = "float32"):
    """Launch csrc/acting_traj.cu (its bf16 arm under bfloat16). Same
    contract as traj_rollout_plain."""
    bf16 = bf16_flag(compute_dtype)
    check_cuda_state(state)
    tower_weights(theta, hidden)  # checks the buffer's length
    if (theta.device != state.pos.device or theta.dtype != torch.float32
            or not theta.is_contiguous()):
        raise ValueError("theta must be a contiguous float32 buffer on the "
                         "state's device")
    lay = traj_layout(hidden, compute_dtype)
    dev = state.pos.device
    planes = torch.empty(T, N_TRAJ, state.n, device=dev)
    packed = torch.empty(lay["wfl"], device=dev)
    fn = cuda_build.load("acting_traj").drone_traj_rollout
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    final, lane_stats = launch_planes(
        fn, state, env_params, statics, T, planes.data_ptr(),
        theta.data_ptr(), packed.data_ptr(), lay["ints"].ctypes.data,
        int(stochastic), bf16)
    traj_rollout_cuda.launches += 1
    traj_rollout_cuda.bf16_launches += bf16
    return final, planes, lane_stats


def traj_rollout_cuda(state: EnvState, theta: torch.Tensor, hidden,
                      env_params: EnvParams, statics: EnvStatics, T: int,
                      stochastic: bool = True,
                      compute_dtype: str = "float32"):
    """T policy+env steps per lane emitting the PPO training planes: the
    kernel on a CUDA state, the plain version on a CPU state. Returns
    (final EnvState, planes (T, N_TRAJ, N), stats dict)."""
    run = (traj_rollout_plain if state.pos.device.type == "cpu"
           else traj_rollout_kernel)
    final, planes, lane_stats = run(state, theta, hidden, env_params, statics,
                                    T, stochastic, compute_dtype)
    return final, planes, stats_dict(lane_stats)


traj_rollout_cuda.launches = 0
traj_rollout_cuda.bf16_launches = 0  # of them, the bf16 arm's
