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

The kernel runs the tower's products on the tensor cores in 3xTF32 (its
weights packed by `pack_tower_mma`) and takes tanh, log, sin and cos from
CUDA's libdevice, so it agrees with the plain version to a tolerance, not
bitwise; the env step inside stays bitwise. `tower_layout` and
`check_smem` describe the fp32 tower, one thread a lane, that K5 and the
trajectory kernel (K2, cuda_acting_traj) ran before their tensor-core
designs: its envelope is the one both keep.
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

# kernel limits (csrc/acting.cu, csrc/policy.cuh)
MAX_HIDDEN = 8
MAX_WIDTH = 256
_CHUNK = 16          # the fp32 tower's envelope: outputs padded to 16,
_THREADS = 128       # 128 lanes a block
ACT_MAX_LANES = 512  # K5's lanes a block (one block an SM at [64, 64])
ACT_CHUNK = 16       # units of K5's fold chunk
ACT_OBS_ROWS = 16    # the obs padded to two k-tiles
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
    """The fp32 tower's shared-memory layout of one tower (the envelope K5
    and K2 keep): each hidden layer as W^T (in, out padded to 16) then its
    padded bias, then the head as W^T (in, n_head) and its bias. Returns
    (the ints [n_hidden, head_off, n_weights, maxw_p, width[MAX_HIDDEN],
    off[MAX_HIDDEN]] as int32, the per-layer offsets). n_weights is
    rounded up to a multiple of 4 floats. Raises for a tower the kernels
    cannot take."""
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
    """Raise ValueError for an actor tower K5 does not take: the envelope of
    the fp32 kernel it replaced (tower_layout's limits and the shared
    memory of a 128-lane block), so that evaluate() routes every tower as
    before; the tensor-core kernel takes every one of them (act_layout).
    evaluate() asks this before it picks K5."""
    layout, _ = tower_layout(widths)
    check_smem(int(layout[2]), widths)
    act_layout(widths)


def _up8(w: int) -> int:
    return -(-w // 8) * 8


def act_layout(widths) -> dict:
    """csrc/acting.cu's `make_act_layout` and `act_smem` for an actor tower
    of hidden `widths`, at the lanes a block the wrapper picks: per layer
    (the head last) its widths, its packed fragments' offset `fo` (float4s)
    and its padded bias's `bo` (floats); the weights buffer's floats `wfl`;
    the activation buffers' first rows (obs, the fold chunk, ping, pong) and
    rows in all. The weights sit in shared memory (`wsm`) when 128 lanes or
    more fit beside them, the lanes `bl` being the most (up to
    ACT_MAX_LANES, a multiple of 32) that fit; otherwise the weights stay
    in device memory. `ints` are the kernel's layout ints [n_hidden, bl,
    wsm, dynamic shared memory bytes, wfl, width[MAX_HIDDEN]]. Raises for a
    tower the kernel cannot take."""
    widths = [int(w) for w in widths]
    if len(widths) > MAX_HIDDEN or any(not 1 <= w <= MAX_WIDTH
                                       for w in widths):
        raise ValueError(f"the acting kernels take at most {MAX_HIDDEN} "
                         f"hidden layers of width <= {MAX_WIDTH}, got {widths}")
    L = len(widths)
    layers, fo, nin, mw = [], 0, OBS_DIM, 0
    for li in range(L + 1):
        nout = widths[li] if li < L else 4
        layers.append({"nin": nin, "nout": nout, "fo": fo})
        fo += _up8(nin) * _up8(nout) // 2
        if li + 2 <= L:
            mw = max(mw, _up8(nout))
        nin = nout
    bo = 4 * fo
    for y in layers:
        y["bo"] = bo
        bo += _up8(y["nout"])
    wfl = -(-bo // 4) * 4
    ch = ACT_OBS_ROWS if L == 1 else 0
    ha = ACT_OBS_ROWS + (ACT_CHUNK if L == 1 else 0)
    hb = ha + (mw if L >= 2 else 0)
    rows = hb + (mw if L >= 3 else 0)
    for wsm, least in ((True, 128), (False, 32)):
        for bl in range(ACT_MAX_LANES, least - 1, -32):
            smem = 4 * ((wfl if wsm else 0) + rows * (bl + 8))
            if smem <= _MAX_SMEM:
                ints = np.zeros(5 + MAX_HIDDEN, np.int32)
                ints[:5] = (L, bl, int(wsm), smem, wfl)
                ints[5:5 + L] = widths
                return {"ints": ints, "layers": layers, "wfl": wfl,
                        "obs": 0, "ch": ch, "ha": ha, "hb": hb, "rows": rows,
                        "bl": bl, "wsm": wsm, "smem": smem}
    raise ValueError(f"towers {widths}: no block of 32 lanes fits")


def pack_tower_mma(policy: ActorCritic, device):
    """The actor tower as K5 reads it (`act_layout`): each layer's B = W^T
    (inputs x outputs, zero-padded to multiples of 8) split into (big,
    small) TF32 halves and packed in the order a warp reads its fragments
    (cnn_mma.cuh's pack_tower_kernel: float4 lane of tile (kt, nt) holds
    big B[k][n], big B[k + 4][n], small B[k][n], small B[k + 4][n], n = 8 nt
    + lane // 4, k = 8 kt + lane % 4), tiles k-major; then each layer's bias
    padded to 8. Returns (buffer, layout ints, std float32 array)."""
    # imported here: cuda_update_cnn imports this module
    from drone_tpu_torch.ops.cuda_update_cnn import tf32_split

    lins = [*policy.hidden_layers("actor"), policy.actor_mean]
    widths = [lin.out_features for lin in lins[:-1]]
    check_envelope(widths)
    lay = act_layout(widths)
    parts = []
    with torch.no_grad():
        for lin, y in zip(lins, lay["layers"]):
            K, N = _up8(y["nin"]), _up8(y["nout"])
            b = torch.zeros(K, N, device=device)
            b[:y["nin"], :y["nout"]] = lin.weight.detach().t().to(
                device, torch.float32)
            halves = []
            for half in tf32_split(b):
                # k = 8 kt + 4 h + t, n = 8 nt + g -> (kt, nt, g, t, h)
                x = half.reshape(K // 8, 2, 4, N // 8, 8).permute(0, 3, 4, 2, 1)
                halves.append(x.reshape(K // 8, N // 8, 32, 2))
            parts.append(torch.cat(halves, -1).reshape(-1))
        for lin, y in zip(lins, lay["layers"]):
            bias = torch.zeros(_up8(y["nout"]), device=device)
            bias[:y["nout"]] = lin.bias.detach().to(device, torch.float32)
            parts.append(bias)
        weights = torch.cat(parts)
        weights = torch.cat([weights, weights.new_zeros(
            lay["wfl"] - weights.numel())]).contiguous()
    std = np.ascontiguousarray(
        torch.exp(policy.log_std.detach()).cpu().numpy(), np.float32)
    return weights, lay["ints"], std


def _pad16(w: int) -> int:
    return -(-w // _CHUNK) * _CHUNK


def act_rollout_kernel(state: EnvState, policy: ActorCritic,
                       env_params: EnvParams, statics: EnvStatics, T: int,
                       stochastic: bool = False):
    """Launch csrc/acting.cu. Same contract as act_rollout_plain."""
    check_cuda_state(state)
    weights, layout, std = pack_tower_mma(policy, state.pos.device)
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
