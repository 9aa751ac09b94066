"""Patch-CNN acting kernels: K11 (serving) and K9 (the training rollout).

Counterpart of `drone_tpu/ops/pallas_acting_cnn.py`. Both kernels are one
CUDA kernel, `csrc/acting_cnn.cu`, over the device functions of
`csrc/cnn.cuh` and the tensor-core tower of `csrc/cnn_mma.cuh`:

  - `cnn_act_rollout_cuda` (K11): T CNN-policy + env steps per lane,
    deterministic by default, episode statistics only; evaluate()'s path
    for run.policy=cnn;
  - `traj_cnn_rollout_cuda` (K9): T stochastic steps streaming K2's (T, 21,
    N) trajectory planes (`cuda_acting_traj`'s TP_* layout), the CNN
    trainer's rollout.

The pixels are never stored: each conv0 patch is re-rendered from the 12
splat scalars of a lane (`splat_planes`) and the patch's pixel coordinates
(`pixels.patch_grid`, one host-built table that the kernels and the plain
versions read alike). The plain versions beside the kernels run the
reference's plane-space math (`cnn_forward`, batch-major here): render,
conv0 per patch, conv1 per window of `conv1_patches`, trunk, heads. The
kernels run the tower's products (conv0, conv1, the trunk) on the tensor
cores in 3xTF32, the updates' forward (`tower_linear` is the hook an
emulation of those takes). The wrappers take the plain version for CPU
tensors only; on a CUDA tensor they launch the kernel, which takes the
default architecture only (`check_envelope`).

`compute_dtype="bfloat16"` is the reference's bf16 operand arm: every
product of the tower and the heads takes its operands rounded to bfloat16
(`cuda_acting_traj.operand`; the rendered pixels are conv0's operand) and
sums in float32. K9's and K11's bf16 arm is one instantiation of the
kernel (one product a k-step of the rounded operands).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.nn import functional as F

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.dynamics import sqrt_rn
from drone_tpu_torch.models.cnn import (  # noqa: F401 (re-exported)
    N_CHAN,
    CnnArch,
    CnnGeom,
    cnn_all_weights,
)
from drone_tpu_torch.ops import cuda_build
from drone_tpu_torch.ops.cuda_acting import gauss4
from drone_tpu_torch.ops.cuda_acting_traj import (
    N_TRAJ,
    bf16_flag,
    operand,
    sample_logp,
)
from drone_tpu_torch.ops.cuda_rollout import (
    N_STATS,
    accumulate,
    check_cuda_state,
    launch_planes,
    stats_dict,
)
from drone_tpu_torch.pixels import (
    SPLAT_SIGMA,
    device_table,
    grid_table,
    patch_grid,
)
from drone_tpu_torch.types import EnvParams, EnvState, EnvStatics

# The one architecture the kernels are built for (csrc/cnn.cuh): the
# reference's PatchCNNActorCritic() defaults, which its trainer always
# builds.
KERNEL_ARCH = CnnArch(24, 4, 2, 64, 64, 128)
# The tensor-core tower's forward tile (csrc/cnn_mma.cuh), which K11, K9,
# the CNN arms of K8 and K6, K10 and K7's CNN arm run: 64 samples (TILE),
# rows of the tile ROW_STRIDE floats apart in shared memory after W0's
# (big, small) fragments: the splat scalars (12), two rendered patches
# (2 x 64), two patches' conv0 outputs (2 x 64, later the tower's output).
TILE = 64
ROW_STRIDE = 72
W0_FRAG_FLOATS = 2 * 64 * 64
TOWER_FWD_ROWS = 12 + 2 * 64 + 2 * 64
TOWER_FWD_SMEM = 4 * (W0_FRAG_FLOATS + ROW_STRIDE * TOWER_FWD_ROWS)  # 109,952
# the forward's packed (big, small) fragments of W0, W1 and Wt, which the
# acting kernels' calls write (cnn_mma.cuh PK_FWD float4s)
FWD_PACKED_FLOATS = 2 * (64 * 64 + 256 * 64 + 576 * 128)   # 188,416
# The bf16 arm's forward tile (cnn_mma.cuh TFB_*): W0's and W1's bf16
# fragments, then the splat scalars (12 fp32 rows), two rendered patches and
# two patches' conv0 outputs (bf16 rows, half a row's floats each: 64 + 64),
# the window's conv1 output as fp32 rows (64) and as bf16 rows (32); its
# packed fragments are bf16 pairs (PKB_FWD uint4s).
W01_FRAG_FLOATS_BF16 = (64 * 64 + 256 * 64) // 2          # 10,240
TOWER_FWD_ROWS_BF16 = 12 + 64 + 64 + 64 + 32
TOWER_FWD_SMEM_BF16 = 4 * (W01_FRAG_FLOATS_BF16
                           + ROW_STRIDE * TOWER_FWD_ROWS_BF16)  # 108,928
FWD_PACKED_FLOATS_BF16 = (64 * 64 + 256 * 64 + 576 * 128) // 2  # 47,104
# float32(1 / (2 * SPLAT_SIGMA^2)): computed in double, then rounded, as the
# reference's render_patch does
RENDER_INV = float(np.float32(1.0 / (2.0 * SPLAT_SIGMA * SPLAT_SIGMA)))


def check_envelope(arch) -> None:
    """Raise ValueError for an architecture the CNN kernels cannot take:
    they are specialized at compile time to the default PatchCNNActorCritic
    (res 24, conv0 4x4/4 -> 64, conv1 2x2/2 -> 64, trunk 128)."""
    if tuple(arch) != tuple(KERNEL_ARCH):
        raise ValueError(f"the CNN kernels take {KERNEL_ARCH} only (the "
                         f"reference's PatchCNNActorCritic defaults), got "
                         f"{CnnArch(*arch)}")


def infer_cnn_arch(state_dict) -> CnnArch:
    """The architecture of a PatchCNNActorCritic state dict, from its shapes
    (the reference's infer_cnn_geom)."""
    c0, k0 = state_dict["conv0.weight"].shape
    c1, k1 = state_dict["conv1.weight"].shape
    hidden, trunk_in = state_dict["trunk.weight"].shape
    p0 = int(round((k0 // N_CHAN) ** 0.5))
    p1 = int(round((k1 // c0) ** 0.5))
    g1 = int(round((trunk_in // c1) ** 0.5))
    if (p0 * p0 * N_CHAN != k0 or p1 * p1 * c0 != k1
            or g1 * g1 * c1 != trunk_in):
        raise ValueError("the conv and trunk shapes do not form a patch CNN")
    return CnnArch(g1 * p1 * p0, p0, p1, int(c0), int(c1), int(hidden))


def infer_cnn_geom(state_dict) -> CnnGeom:
    return infer_cnn_arch(state_dict).geom


def splat_planes(X):
    """The 12 splat scalars of each lane: X (N, 13) obs -> 4 x (u0, u1, amp),
    each (N,). The reference's splat_planes (left-associated three-term
    sums, 1 / (1 + n) multiplied in), which pixels.splat_inputs computes
    with divisions instead."""
    rel0, rel1, rel2 = X[:, 0], X[:, 1], X[:, 2]
    w, x, y, z = X[:, 3], X[:, 4], X[:, 5], X[:, 6]
    r00, r01, r02 = 1 - 2 * (y * y + z * z), 2 * (x * y + w * z), 2 * (x * z - w * y)
    r10, r11, r12 = 2 * (x * y - w * z), 1 - 2 * (x * x + z * z), 2 * (y * z + w * x)
    r20, r21, r22 = 2 * (x * z + w * y), 2 * (y * z - w * x), 1 - 2 * (x * x + y * y)

    def body3(v0, v1, v2):
        return (r00 * v0 + r01 * v1 + r02 * v2,
                r10 * v0 + r11 * v1 + r12 * v2,
                r20 * v0 + r21 * v1 + r22 * v2)

    one = torch.ones((), dtype=X.dtype, device=X.device)

    def dir2(v0, v1, v2):
        n = sqrt_rn(v0 * v0 + v1 * v1 + v2 * v2)
        inv = one / (one + n)
        return v0 * inv, v1 * inv, n

    t0, t1, d_t = dir2(*body3(rel0, rel1, rel2))
    v0, v1, d_v = dir2(*body3(X[:, 7], X[:, 8], X[:, 9]))
    w0, w1, d_w = dir2(X[:, 10], X[:, 11], X[:, 12])
    return ((t0, t1, one / (one + d_t)),
            (r02, r12, 0.5 + 0.5 * r22),
            (v0, v1, d_v / (one + d_v)),
            (w0, w1, d_w / (one + d_w)))


def render_patches(sp, gx, gy, geom: CnnGeom):
    """Every conv0 input block: splat scalars `sp` and the patch-major pixel
    coordinates gx / gy (res^2,) -> (N, n_q0, C * p0^2), each patch's rows
    channel-major (the reference's render_patch for all patches)."""
    pp = geom.p0 * geom.p0
    gxp = gx.view(1, geom.n_q0, pp)
    gyp = gy.view(1, geom.n_q0, pp)
    inv = torch.full((), RENDER_INV, dtype=torch.float32, device=gx.device)
    rows = []
    for u0, u1, amp in sp:
        d2 = (gxp - u0[:, None, None]) ** 2 + (gyp - u1[:, None, None]) ** 2
        rows.append(amp[:, None, None] * torch.exp(-d2 * inv))
    return torch.cat(rows, dim=2)


def conv1_patches(geom: CnnGeom):
    """The conv0 patches of each conv1 window, in (di, dj) order: the
    window's input rows."""
    return [[(pi * geom.p1 + di) * geom.g0 + (pj * geom.p1 + dj)
             for di in range(geom.p1) for dj in range(geom.p1)]
            for pi in range(geom.g1) for pj in range(geom.g1)]


def window_index(geom: CnnGeom, device) -> torch.Tensor:
    """conv1_patches as an (n_q1, p1^2) int64 tensor."""
    return device_table(("conv1_patches", geom.key),
                        lambda: np.array(conv1_patches(geom), np.int64), device)


def tower_linear(x, w, b):
    """F.linear for the tower's layers (conv0, conv1, the trunk), whose
    products every CNN kernel runs in 3xTF32; an emulation of those
    (cuda_update_cnn.mm_3xtf32) can take its place."""
    return F.linear(x, w, b)


def cnn_encode(X, enc_weights, gx, gy, geom: CnnGeom, want_acts=False,
               compute_dtype: str = "float32"):
    """The patchify-CNN encoder in the kernels' formulation: X (N, 13) ->
    trunk features h (N, hidden) [, acts = (sp, X0 (N, n_q0, C p0^2), Y0
    (N, n_q0, c0), Y1 (N, n_q1, c1), X2 (N, n_q1 c1), h)], each product's
    operands as `operand` takes them."""
    W0, b0, W1, b1, Wt, bt = enc_weights
    n = X.shape[0]

    def layer(x, w, b):
        return torch.relu(tower_linear(operand(x, compute_dtype),
                                       operand(w, compute_dtype), b))

    sp = splat_planes(X)
    X0 = render_patches(sp, gx, gy, geom)
    Y0 = layer(X0, W0, b0)
    X1 = Y0[:, window_index(geom, X.device)].reshape(n, geom.n_q1, -1)
    Y1 = layer(X1, W1, b1)
    X2 = Y1.reshape(n, -1)
    h = layer(X2, Wt, bt)
    if want_acts:
        return h, (sp, X0, Y0, Y1, X2, h)
    return h


def cnn_forward(X, weights, gx, gy, geom: CnnGeom, want_acts=False,
                compute_dtype: str = "float32"):
    """cnn_encode plus the heads: X (N, 13) -> (means (N, 4), values (N,)[,
    acts])."""
    W0, b0, W1, b1, Wt, bt, (hw, hb), (vw, vb), _ = weights
    h, acts = cnn_encode(X, (W0, b0, W1, b1, Wt, bt), gx, gy, geom, True,
                         compute_dtype)
    hr = operand(h, compute_dtype)
    m = F.linear(hr, operand(hw, compute_dtype), hb)
    v = F.linear(hr, operand(vw, compute_dtype), vb)[:, 0]
    return (m, v, acts) if want_acts else (m, v)


@torch.no_grad()
def cnn_act_rollout_plain(state: EnvState, theta, arch, env_params: EnvParams,
                          statics: EnvStatics, T: int,
                          stochastic: bool = False,
                          compute_dtype: str = "float32"):
    """Plain PyTorch version of K11. Returns (final EnvState, per-lane
    statistics (N_STATS, N))."""
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = CnnArch(*arch)
    weights = cnn_all_weights(theta, arch)
    gx, gy = patch_grid(arch.res, arch.p0, state.pos.device)
    acc = torch.zeros(N_STATS, state.n, device=state.pos.device)
    for _ in range(T):
        m, _ = cnn_forward(env_mod.observe(state), weights, gx, gy, arch.geom,
                           compute_dtype=compute_dtype)
        a = m
        if stochastic:
            a, _ = sample_logp(m, gauss4(state), weights[-1], True)
        state, out = env_mod.step(state, a, env_params, statics)
        acc = accumulate(acc, out)
    return state, acc


@torch.no_grad()
def traj_cnn_rollout_plain(state: EnvState, theta, arch,
                           env_params: EnvParams, statics: EnvStatics, T: int,
                           stochastic: bool = True,
                           compute_dtype: str = "float32"):
    """Plain PyTorch version of K9 (traj_cnn_rollout_reference). Returns
    (final EnvState, planes (T, N_TRAJ, N), per-lane statistics)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = CnnArch(*arch)
    weights = cnn_all_weights(theta, arch)
    dev = state.pos.device
    gx, gy = patch_grid(arch.res, arch.p0, dev)
    planes = torch.empty(T, N_TRAJ, state.n, device=dev)
    acc = torch.zeros(N_STATS, state.n, device=dev)
    for t in range(T):
        obs = env_mod.observe(state)
        m, v = cnn_forward(obs, weights, gx, gy, arch.geom,
                           compute_dtype=compute_dtype)
        z = gauss4(state) if stochastic else torch.zeros_like(m)
        a, logp = sample_logp(m, z, weights[-1], stochastic)
        state, out = env_mod.step(state, a, env_params, statics)
        done = (out.terminated | out.truncated).to(torch.float32)
        planes[t] = torch.cat([obs.t(), a.t(), logp[None], v[None],
                               out.reward[None], done[None]])
        acc = accumulate(acc, out)
    return state, planes, acc


def _launch(state, theta, arch, env_params, statics, T, traj: bool,
            stochastic: bool, bf16: int):
    """Launch csrc/acting_cnn.cu: serving (K11) when traj is False, else the
    training rollout (K9); its bf16 arm when bf16 is 1. Returns (final
    EnvState, planes or None, per-lane statistics)."""
    check_cuda_state(state)
    arch = CnnArch(*arch)
    check_envelope(arch)
    dev = state.pos.device
    cnn_all_weights(theta, arch)  # checks the buffer's length
    if (theta.device != dev or theta.dtype != torch.float32
            or not theta.is_contiguous()):
        raise ValueError("theta must be a contiguous float32 buffer on the "
                         "state's device")
    pk = torch.empty(FWD_PACKED_FLOATS_BF16 if bf16 else FWD_PACKED_FLOATS,
                     device=dev)  # packed by the call
    grid = grid_table(arch.res, arch.p0, dev)
    planes = torch.empty(T, N_TRAJ, state.n, device=dev) if traj else None
    fn = cuda_build.load("acting_cnn").drone_cnn_act_rollout
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    final, lane_stats = launch_planes(
        fn, state, env_params, statics, T, theta.data_ptr(), pk.data_ptr(),
        grid.data_ptr(), None if planes is None else planes.data_ptr(),
        int(stochastic), TOWER_FWD_SMEM_BF16 if bf16 else TOWER_FWD_SMEM,
        bf16)
    return final, planes, lane_stats


def cnn_act_rollout_kernel(state, theta, arch, env_params, statics, T,
                           stochastic=False, compute_dtype="float32"):
    """Launch K11. Same contract as cnn_act_rollout_plain."""
    bf16 = bf16_flag(compute_dtype)
    final, _, lane_stats = _launch(state, theta, arch, env_params, statics, T,
                                   False, stochastic, bf16)
    cnn_act_rollout_cuda.launches += 1
    cnn_act_rollout_cuda.bf16_launches += bf16
    return final, lane_stats


def traj_cnn_rollout_kernel(state, theta, arch, env_params, statics, T,
                            stochastic=True, compute_dtype="float32"):
    """Launch K9. Same contract as traj_cnn_rollout_plain."""
    bf16 = bf16_flag(compute_dtype)
    out = _launch(state, theta, arch, env_params, statics, T, True,
                  stochastic, bf16)
    traj_cnn_rollout_cuda.launches += 1
    traj_cnn_rollout_cuda.bf16_launches += bf16
    return out


def cnn_act_rollout_cuda(state: EnvState, theta, arch, env_params: EnvParams,
                         statics: EnvStatics, T: int,
                         stochastic: bool = False,
                         compute_dtype: str = "float32"):
    """T CNN-policy + env steps per lane, statistics only: the kernel on a
    CUDA state, the plain version on a CPU state. theta: the flat buffer of
    a PatchCNNActorCritic of architecture `arch`. Returns (final EnvState,
    stats dict)."""
    run = (cnn_act_rollout_plain if state.pos.device.type == "cpu"
           else cnn_act_rollout_kernel)
    final, lane_stats = run(state, theta, arch, env_params, statics, T,
                            stochastic, compute_dtype)
    return final, stats_dict(lane_stats)


cnn_act_rollout_cuda.launches = 0
cnn_act_rollout_cuda.bf16_launches = 0  # of them, the bf16 arm's


def traj_cnn_rollout_cuda(state: EnvState, theta, arch,
                          env_params: EnvParams, statics: EnvStatics, T: int,
                          stochastic: bool = True,
                          compute_dtype: str = "float32"):
    """T CNN-policy + env steps per lane emitting the PPO training planes:
    the kernel on a CUDA state, the plain version on a CPU state. Returns
    (final EnvState, planes (T, N_TRAJ, N), stats dict)."""
    run = (traj_cnn_rollout_plain if state.pos.device.type == "cpu"
           else traj_cnn_rollout_kernel)
    final, planes, lane_stats = run(state, theta, arch, env_params, statics,
                                    T, stochastic, compute_dtype)
    return final, planes, stats_dict(lane_stats)


traj_cnn_rollout_cuda.launches = 0
traj_cnn_rollout_cuda.bf16_launches = 0  # of them, the bf16 arm's
