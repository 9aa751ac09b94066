"""PPO update kernels: K3, one minibatch of clipped-PPO forward+backward,
and K4, clip_by_global_norm + adam in one launch.

Counterpart of `drone_tpu/ops/pallas_update.py`. The kernels are in
`csrc/update.cu`. Their plain PyTorch versions sit beside them:
`ppo_update_plain` is the hand-written backprop of `_block_grads` in
vectorized torch over the gathered minibatch, `fused_adam_plain` is
`_adam_math`. `ppo_update_cuda` and `fused_adam_cuda` take the plain
version for CPU tensors only; on a CUDA tensor they launch the kernel.

The parameters, their gradients and the adam moments are flat float32
buffers in the reference's `_kernel_tensors` order (`models.mlp.
kernel_order`). K4 updates the parameters, the moments and the step count
in place (the module's parameters are views of the buffer, so they follow),
and takes the learning rate's linear anneal (`LrSchedule`) from the count
on the device.

Gradient conventions (CleanRL/PuffeRL clipped PPO, as the reference):
  total = mean(pg) + vf_coef * 0.5 * mean(vl) - ent_coef * ent
  pg    = max(-adv*ratio, -adv*clip(ratio, 1 +- clip_eps))
  vl    = max((v-ret)^2, (v_old+clip(v-v_old, +-vf_clip)-ret)^2)
max/clip subgradients: the first branch wins ties; clip passes gradient
inside the closed interval.

`compute_dtype="bfloat16"` is the reference's bf16 operand arm of K3: the
forward's, dW's and dX's products take their operands rounded to bfloat16
(`cuda_acting_traj.operand`, the reference's `_dot32`) and sum in float32;
db, the tanh, its derivative and the head stay float32. The kernel's bf16
arm is its own design (`b16_layout`): m16n8k16 bf16 products of operands
stored once as bf16.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from drone_tpu_torch.dynamics import sqrt_rn
from drone_tpu_torch.models.mlp import kernel_offsets, kernel_order
from drone_tpu_torch.ops import cuda_build
from drone_tpu_torch.ops.cuda_acting_traj import (
    HALF_LOG_2PI,
    N_TRAJ,
    TP_ACT0,
    TP_LOGP,
    TP_OBS0,
    TP_VAL,
    bf16_flag,
    operand,
    tower_weights,
)
from drone_tpu_torch.types import OBS_DIM

# update-stat sums: policy loss, value loss terms, approx-KL, clip fraction,
# then the 4 per-dim log_std gradient contributions
ST_PG, ST_VL, ST_KL, ST_CF = 0, 1, 2, 3
ST_DLS0 = 4
N_UPSTATS = 8

# kernel limits (csrc/update.cu)
UPD_HIDDEN = 8
TILE = 64
MAX_BLOCKS = 128       # one block an SM; 8,192 / 128 tiles a block
_MAX_SMEM = 232448     # bytes of shared memory one H100 block can use
W0_STRIDE = 20         # layer 0's weight-plane rows
SLACK_ROWS = 16        # activation rows past the head's value
STAT_PART_BYTES = 8 * 8 * 4  # the static stat partials of 8 warps
B16_S = TILE + 8       # the bf16 arm's activation rows (bf16 a row)
B16_MAX_BLOCKS = 132   # its blocks: one an SM of an H100
# its static shared memory: the BLayout (5 + 2 x 9 layers of 10 ints) and
# the head's 8 warps' 13 sums
B16_STATIC_BYTES = 4 * (5 + 2 * (UPD_HIDDEN + 1) * 10) + 8 * 13 * 4
ADAM_SLICE = 2048      # K4: floats a slice, one slice a block up to
ADAM_MAX_BLOCKS = 256  # K4: blocks a launch, all co-resident on an H100
ADAM_MAX_P = 1 << 30   # K4: the largest buffer (slice offsets within int)
_FP32_ROW = TILE + 1   # the fp32 kernel's row stride, its envelope


@dataclasses.dataclass(frozen=True)
class UpdateConsts:
    """PPO constants of the update (pallas_update.UpdateConsts)."""

    clip_eps: float
    vf_clip: float
    vf_coef: float
    inv_m: float     # 1 / (samples per minibatch)


@dataclasses.dataclass(frozen=True)
class AdamConsts:
    """Optimizer constants (ppo.make_optimizer's chain)."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-5
    clip_norm: float = 0.5


@dataclasses.dataclass(frozen=True)
class LrSchedule:
    """lr, or its linear anneal to 0 over total_steps optimizer steps
    (ppo_pallas.make_fused_lr), as a function of the step count."""

    lr: float
    total_steps: int
    anneal: bool

    def __call__(self, count: torch.Tensor) -> torch.Tensor:
        lr = torch.tensor(self.lr, dtype=torch.float32, device=count.device)
        if not self.anneal:
            return lr
        total = torch.tensor(float(self.total_steps), dtype=torch.float32,
                             device=count.device)
        return lr * (1.0 - torch.clamp_max(count / total, 1.0))


def minibatch_lanes(perm_mb: torch.Tensor, rbl: int) -> torch.Tensor:
    """Lane indices of the row blocks perm_mb (rbl lanes each), in order."""
    offs = torch.arange(rbl, device=perm_mb.device)
    return (perm_mb.to(torch.int64)[:, None] * rbl + offs).reshape(-1)


def _f32(x: float) -> float:
    return float(np.float32(x))


def head_grads(m, v, a, logp_old, v_old, adv, ret, ls, co: UpdateConsts):
    """_head_grads over a batch of samples: m (S, 4), v (S,), a (S, 4), the
    rest (S,), ls (4,). Returns (dm (S, 4), g_v (S,), stats (S, 8))."""
    inv_m = _f32(co.inv_m)
    lo, hi = _f32(1.0 - co.clip_eps), _f32(1.0 + co.clip_eps)
    std = torch.exp(ls)
    z = (a - m) / std
    terms = -0.5 * (z * z) - ls - HALF_LOG_2PI
    lp = ((terms[:, 0] + terms[:, 1]) + terms[:, 2]) + terms[:, 3]
    ratio = torch.exp(lp - logp_old)
    pg1 = -adv * ratio
    pg2 = -adv * torch.clamp(ratio, lo, hi)
    pg = torch.maximum(pg1, pg2)
    inclip = (ratio >= lo) & (ratio <= hi)
    dpg = torch.where((pg1 >= pg2) | inclip, -adv, 0.0)
    g_logp = inv_m * dpg * ratio

    dv_raw = v - ret
    vdiff = torch.clamp(v - v_old, -co.vf_clip, co.vf_clip)
    dv_c = (v_old + vdiff) - ret
    vl = torch.maximum(dv_raw * dv_raw, dv_c * dv_c)
    use_raw = (dv_raw * dv_raw) >= (dv_c * dv_c)
    in_vclip = (v - v_old >= -co.vf_clip) & (v - v_old <= co.vf_clip)
    dvl = torch.where(use_raw, 2.0 * dv_raw,
                      torch.where(in_vclip, 2.0 * dv_c, 0.0))
    g_v = _f32(0.5 * co.vf_coef) * inv_m * dvl

    dm = g_logp[:, None] * (z / torch.exp(ls))
    stats = torch.stack([pg, vl, logp_old - lp,
                         (torch.abs(ratio - 1.0) > co.clip_eps).to(torch.float32),
                         *(g_logp * (z[:, k] * z[:, k] - 1.0) for k in range(4))],
                        1)
    return dm, g_v, stats


def tower_mm(a, b):
    """a @ b for the towers' products (the forward, dW and dX), which K3
    runs on the tensor cores in 3xTF32; `cuda_update_cnn.mm_3xtf32` can
    take its place to see what that precision costs the plain version."""
    return a @ b


def _tower_fwd(x, weights, compute_dtype="float32"):
    acts = [x]
    for li, (w, b) in enumerate(weights):
        x = tower_mm(operand(x, compute_dtype),
                     operand(w, compute_dtype).t()) + b
        if li < len(weights) - 1:
            x = torch.tanh(x)
        acts.append(x)
    return x, acts


def _tower_bwd(weights, acts, dy, compute_dtype="float32"):
    """dy (S, out) of the head -> [(dW (out, in), db (out,)), ...]."""
    def op(x):
        return operand(x, compute_dtype)

    grads = [None] * len(weights)
    for li in range(len(weights) - 1, -1, -1):
        w, _ = weights[li]
        grads[li] = (tower_mm(op(dy).t(), op(acts[li])), dy.sum(0))
        if li > 0:
            y = acts[li]
            dy = tower_mm(op(dy), op(w)) * (1.0 - y * y)
    return grads


def gather_minibatch(planes, advret, perm_mb, rbl):
    """The minibatch's samples, sample-major: (X (S, 13), a (S, 4),
    logp_old, v_old, adv, ret (S,)), S = T * n_sel * rbl (time-major)."""
    lanes = minibatch_lanes(perm_mb, rbl)
    blk = planes[:, :, lanes]                    # (T, 21, M)
    ar = advret[:, :, lanes]                     # (2, T, M)
    flat = blk.permute(1, 0, 2).reshape(N_TRAJ, -1)
    X = flat[TP_OBS0:TP_OBS0 + OBS_DIM].t()
    a = flat[TP_ACT0:TP_ACT0 + 4].t()
    return X, a, flat[TP_LOGP], flat[TP_VAL], ar[0].reshape(-1), ar[1].reshape(-1)


def ppo_update_plain(planes, advret, perm_mb, theta, hidden,
                     co: UpdateConsts, rbl: int, ent_coef: float = 0.0,
                     compute_dtype: str = "float32"):
    """Plain PyTorch version of K3 (_block_grads over the whole minibatch).
    Returns (grads (P,) in kernel order, stat sums (N_UPSTATS,)). Gradients
    are sums scaled by inv_m; log_std's is its stat sums minus ent_coef."""
    bf16_flag(compute_dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    actor, critic, ls = tower_weights(theta, hidden)
    X, a, logp_old, v_old, adv, ret = gather_minibatch(planes, advret,
                                                       perm_mb, rbl)
    with torch.no_grad():
        m, acts_a = _tower_fwd(X, actor, compute_dtype)
        vx, acts_c = _tower_fwd(X, critic, compute_dtype)
        dm, g_v, stats = head_grads(m, vx[:, 0], a, logp_old, v_old, adv, ret,
                                    ls, co)
        ga = _tower_bwd(actor, acts_a, dm, compute_dtype)
        gc = _tower_bwd(critic, acts_c, g_v[:, None], compute_dtype)
        st = stats.sum(0)
        offs, total = kernel_offsets(hidden)
        grads = torch.empty(total, device=theta.device)
        names = [name for name, _ in kernel_order(hidden)]
        for name, g in zip(names, [t for wb in (*ga, *gc) for t in wb]):
            grads[offs[name]:offs[name] + g.numel()] = g.reshape(-1)
        grads[offs["log_std"]:offs["log_std"] + 4] = st[ST_DLS0:] - ent_coef
    return grads, st


@torch.no_grad()
def head_branch_counts(planes, advret, perm_mb, theta, hidden,
                       co: UpdateConsts, rbl: int,
                       compute_dtype: str = "float32") -> dict:
    """How many samples of a minibatch take each branch of the head's
    subgradients at theta: the ratio outside 1 +- clip_eps, of which the
    clipped surrogate wins (policy gradient 0), and v - v_old outside
    +-vf_clip, of which the clipped value loss wins (value gradient 0).
    A check of K3 that holds it to its plain version needs every branch."""
    actor, critic, ls = tower_weights(theta, hidden)
    X, a, logp_old, v_old, adv, ret = gather_minibatch(planes, advret,
                                                       perm_mb, rbl)
    m, _ = _tower_fwd(X, actor, compute_dtype)
    v = _tower_fwd(X, critic, compute_dtype)[0][:, 0]
    return branch_counts(m, v, a, logp_old, v_old, adv, ret, ls, co)


def branch_counts(m, v, a, logp_old, v_old, adv, ret, ls,
                  co: UpdateConsts) -> dict:
    """head_branch_counts from the head's inputs over a batch of samples
    (head_grads' arguments); any policy family."""
    dm, g_v, stats = head_grads(m, v, a, logp_old, v_old, adv, ret, ls, co)
    value_out = torch.abs(v - v_old) > co.vf_clip
    return {"samples": m.shape[0],
            "ratio_out": int(stats[:, ST_CF].sum()),
            "policy_grad_zero": int((dm == 0).all(1).sum()),
            "value_out": int(value_out.sum()),
            "value_grad_zero": int((value_out & (g_v == 0)).sum())}


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def sums_stride(nin: int) -> int:
    """A running-sum row of K3: nin floats of W's row and the bias, rounded
    up to 8 mod 16 floats (its fragments' float2 adds free of bank
    conflicts)."""
    return nin + 1 + (8 - (nin + 1) % 16) % 16


def mma_layout(hidden) -> dict:
    """csrc/update.cu's `make_layout` and `layout_smem` for towers `hidden`:
    per tower and layer (the head last) its input and output widths, its
    weight planes' offset `wp`, row stride `sw` and swizzle, its running
    sums' offset `sb` and row stride `ss`, its activation rows; the
    floats of one weight plane `wf` and of the running sums `sf`, the
    activation rows, whether the planes and the sums fit beside the
    activations in a block's shared memory (`onchip`), and its dynamic
    shared memory in bytes."""
    hidden = tuple(int(h) for h in hidden)
    L, h = len(hidden), sum(hidden)
    hm = OBS_DIM + 2 * h
    hv = hm + 4
    rows = hv + 1 + SLACK_ROWS
    layers, wp, sb = [[], []], 0, 0
    for t in (0, 1):
        base, cum, nin, in_row = OBS_DIM + t * h, 0, OBS_DIM, 0
        for li in range(L + 1):
            nout = hidden[li] if li < L else (4, 1)[t]
            sw = _up(nin, 32) if li else W0_STRIDE
            out_row = base + cum if li < L else (hm, hv)[t]
            layers[t].append(dict(nin=nin, nout=nout, wp=wp, sw=sw,
                                  swizzled=li > 0, sb=sb,
                                  ss=sums_stride(nin), in_row=in_row,
                                  out_row=out_row))
            wp += _up(nout, 8) * sw
            sb += nout * sums_stride(nin)
            in_row, cum, nin = out_row, cum + nout, nout
    act = 4 * rows * TILE
    onchip = act + 4 * (2 * wp + sb) + STAT_PART_BYTES <= _MAX_SMEM
    return dict(layers=layers, wf=wp, sf=sb, rows=rows, hm=hm, hv=hv,
                onchip=onchip, smem=act + (4 * (2 * wp + sb) if onchip else 0))


def b16_layout(hidden) -> dict:
    """csrc/update.cu's `make_layout_b16` and `layout_smem_b16` for towers
    `hidden` (K3's bf16 arm): per tower and layer (the head last) its
    widths, the offsets of its A fragments `fa` (W) and `ta` (W^T, layers
    past the first) in uint4s, its running sums' `sb` and row stride `ss`,
    its bf16 rows `in_row`, `out_row` and its output's fp32 rows `y32`; the
    uint4s of the fragments `wq`, the floats of the running sums `sf`, the
    bf16 rows and the fp32 tanh rows, whether the tanh rows, the fragments
    and the running sums fit in a block's shared memory (`onchip`), its
    dynamic shared memory in bytes, and the floats of a block's scratch row
    off chip (0 on chip)."""
    hidden = tuple(int(h) for h in hidden)
    L, h = len(hidden), sum(hidden)
    h16 = sum(_up(w, 16) for w in hidden)
    rows = 16 + 2 * h16 + 2 * 16
    layers, q, sb = [[], []], 0, 0
    for t in (0, 1):
        row, yrow, nin, in_row = 16 + t * h16, t * h, OBS_DIM, 0
        for li in range(L + 1):
            nout = hidden[li] if li < L else (4, 1)[t]
            fa = q
            q += _up(nout, 16) // 16 * (_up(nin, 16) // 16) * 32
            ta = q
            if li:
                q += _up(nin, 16) // 16 * (_up(nout, 16) // 16) * 32
            out_row = row if li < L else 16 + 2 * h16 + 16 * t
            layers[t].append(dict(nin=nin, nout=nout, fa=fa, ta=ta, sb=sb,
                                  ss=sums_stride(nin), in_row=in_row,
                                  out_row=out_row,
                                  y32=yrow if li < L else 4 * t))
            sb += nout * sums_stride(nin)
            if li < L:
                row, yrow = row + _up(nout, 16), yrow + nout
            in_row, nin = out_row, nout
    base = 2 * rows * B16_S + 4 * 8 * TILE
    full = base + 4 * 2 * h * TILE + 16 * q + 4 * sb
    onchip = full + B16_STATIC_BYTES <= _MAX_SMEM
    return dict(layers=layers, wq=q, sf=sb, rows=rows, yrows=2 * h,
                onchip=onchip, smem=full if onchip else base,
                scratch=0 if onchip else sb + 2 * h * TILE)


def update_layout(hidden) -> np.ndarray:
    """The host ints of drone_ppo_update: [n_hidden, widths, actor W
    offsets, critic W offsets, P, ls_off]. Raises for a tower the kernel
    cannot take: the envelope of the fp32 kernel it replaced (at most
    UPD_HIDDEN hidden layers, the tile's activations in a block's shared
    memory at 65 floats a row), inside which the tensor-core kernel's
    activations always fit."""
    hidden = tuple(int(h) for h in hidden)
    rows = OBS_DIM + 2 * sum(hidden) + 5 + 8
    if (len(hidden) > UPD_HIDDEN or min(hidden, default=1) < 1
            or 4 * rows * _FP32_ROW > _MAX_SMEM):
        raise ValueError(f"the update kernel takes at most {UPD_HIDDEN} hidden "
                         f"layers and {_MAX_SMEM} bytes of activations per "
                         f"tile; towers {list(hidden)} need "
                         f"{4 * rows * _FP32_ROW}")
    if mma_layout(hidden)["smem"] + STAT_PART_BYTES > _MAX_SMEM:
        raise ValueError(f"towers {list(hidden)}: the tile's activations "
                         f"exceed a block's shared memory")
    offs, total = kernel_offsets(hidden)
    ints = np.zeros(5 + 3 * UPD_HIDDEN, np.int32)
    ints[0] = len(hidden)
    ints[1:1 + len(hidden)] = hidden
    for t, (tower, head) in enumerate((("actor", "actor_mean"),
                                       ("critic", "critic_value"))):
        names = [f"{tower}_h{i}" for i in range(len(hidden))] + [head]
        base = 1 + UPD_HIDDEN + t * (UPD_HIDDEN + 1)
        ints[base:base + len(names)] = [offs[f"{n}.weight"] for n in names]
    ints[3 + 3 * UPD_HIDDEN] = total
    ints[4 + 3 * UPD_HIDDEN] = offs["log_std"]
    return ints


def check_cuda_tensor(name, t, dtype, shape=None):
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got "
                         f"{tuple(t.shape)}")


def ppo_update_kernel(planes, advret, perm_mb, theta, hidden,
                      co: UpdateConsts, rbl: int, ent_coef: float = 0.0,
                      compute_dtype: str = "float32"):
    """Launch K3 (csrc/update.cu; its bf16 arm under bfloat16). Same
    contract as ppo_update_plain."""
    bf16 = bf16_flag(compute_dtype)
    T, _, n = planes.shape
    layout = update_layout(hidden)
    P = int(layout[3 + 3 * UPD_HIDDEN])
    check_cuda_tensor("planes", planes, torch.float32, (T, N_TRAJ, n))
    check_cuda_tensor("advret", advret, torch.float32, (2, T, n))
    check_cuda_tensor("perm_mb", perm_mb, torch.int32)
    check_cuda_tensor("theta", theta, torch.float32, (P,))
    if rbl % TILE or n % rbl:
        raise ValueError(f"row blocks of {rbl} lanes: the kernel needs a "
                         f"multiple of {TILE} that divides {n}")
    n_tiles = perm_mb.numel() * (rbl // TILE) * T
    G = min(n_tiles, B16_MAX_BLOCKS if bf16 else MAX_BLOCKS)
    if bf16:
        mm = b16_layout(hidden)
        packed, row = 4 * mm["wq"], mm["scratch"]
        dims = np.array([mm["smem"], int(mm["onchip"]), mm["wq"], row],
                        np.int32)
    else:
        mm = mma_layout(hidden)
        packed, row = 2 * mm["wf"], 0 if mm["onchip"] else mm["sf"]
        dims = np.array([mm["smem"], int(mm["onchip"]), mm["wf"], mm["sf"]],
                        np.int32)
    dev = planes.device
    wplanes = torch.empty(packed, device=dev)
    scratch = torch.empty(max(1, G * row), device=dev)
    partial = torch.empty(G, P + N_UPSTATS, device=dev)
    grads = torch.empty(P, device=dev)
    stats = torch.empty(N_UPSTATS, device=dev)
    consts = np.array([co.inv_m, 1.0 - co.clip_eps, 1.0 + co.clip_eps,
                       co.clip_eps, co.vf_clip, 0.5 * co.vf_coef, ent_coef],
                      np.float32)
    fn = cuda_build.load("update").drone_ppo_update
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(planes.data_ptr(), advret.data_ptr(), perm_mb.data_ptr(),
                 theta.data_ptr(), wplanes.data_ptr(), scratch.data_ptr(),
                 partial.data_ptr(), grads.data_ptr(), stats.data_ptr(),
                 layout.ctypes.data, consts.ctypes.data, dims.ctypes.data, n,
                 T, rbl, perm_mb.numel(), G, bf16,
                 torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "drone_ppo_update")
    ppo_update_cuda.launches += 1
    ppo_update_cuda.bf16_launches += bf16
    return grads, stats


def ppo_update_cuda(planes, advret, perm_mb, theta, hidden,
                    co: UpdateConsts, rbl: int, ent_coef: float = 0.0,
                    compute_dtype: str = "float32"):
    """One PPO minibatch gradient pass over the trajectory planes: the
    kernel on CUDA tensors, the plain version on CPU tensors.

    planes: (T, N_TRAJ, N) from the trajectory rollout; advret: (2, T, N)
    (normalized advantage, return); perm_mb: (n_sel,) int32 row-block
    indices, block i covering lanes [i*rbl, (i+1)*rbl); theta: the flat
    parameters of towers `hidden`; compute_dtype "float32" or "bfloat16"
    (the bf16 operand arm). Returns (grads (P,), stat sums (8,))."""
    run = ppo_update_plain if planes.device.type == "cpu" else ppo_update_kernel
    return run(planes, advret, perm_mb, theta, hidden, co, rbl, ent_coef,
               compute_dtype)


ppo_update_cuda.launches = 0
ppo_update_cuda.bf16_launches = 0  # of them, the bf16 arm's


@torch.no_grad()
def fused_adam_plain(theta, grads, mu, nu, count, ac: AdamConsts,
                     sched: LrSchedule, sizes):
    """Plain PyTorch version of K4 (_adam_math): updates theta, mu, nu and
    count in place. `sizes` are the element counts of the flat buffer's
    tensors in kernel order (`models.tensor_sizes`, any policy family): the
    squared norm sums each tensor, then adds the sums in that order, as the
    reference does."""
    if sum(sizes) != theta.numel():
        raise ValueError(f"tensor sizes sum to {sum(sizes)}, the buffer has "
                         f"{theta.numel()} floats")
    ss = None
    for g in torch.split(grads, list(sizes)):
        s = torch.sum(g * g)
        ss = s if ss is None else ss + s
    gn = sqrt_rn(ss)
    clip = torch.tensor(ac.clip_norm, dtype=torch.float32, device=gn.device)
    scale = torch.where(gn > clip, clip / gn, 1.0)
    lr = sched(count)
    c = count + 1.0
    bc1 = 1.0 - torch.exp(c * _f32(math.log(ac.b1)))
    bc2 = 1.0 - torch.exp(c * _f32(math.log(ac.b2)))
    b1, b2 = np.float32(ac.b1), np.float32(ac.b2)
    gc = grads * scale
    mu2 = float(b1) * mu + float(np.float32(1.0) - b1) * gc
    nu2 = float(b2) * nu + float(np.float32(1.0) - b2) * (gc * gc)
    upd = -lr * (mu2 / bc1) / (sqrt_rn(nu2 / bc2) + _f32(ac.eps))
    theta.add_(upd)
    mu.copy_(mu2)
    nu.copy_(nu2)
    count.copy_(c)


def adam_blocks(P: int) -> int:
    """K4's blocks for a buffer of P floats, min(ceil(P / ADAM_SLICE),
    ADAM_MAX_BLOCKS): a function of P alone, so the order of the gradient
    norm's sums never depends on the card. Raises for P outside 1 ..
    ADAM_MAX_P."""
    if P <= 0 or P > ADAM_MAX_P:
        raise ValueError(f"K4 takes 1 to {ADAM_MAX_P} parameters, got {P}")
    return min(-(-P // ADAM_SLICE), ADAM_MAX_BLOCKS)


def adam_slices(P: int) -> list[tuple[int, int]]:
    """The slices [start, stop) of the buffer in order; block b of K4's
    adam_blocks(P) owns the slices b, b + blocks, b + 2 blocks, ... (one
    each up to ADAM_MAX_BLOCKS * ADAM_SLICE floats) and sums their squares
    in that order."""
    adam_blocks(P)
    return [(start, min(P, start + ADAM_SLICE))
            for start in range(0, P, ADAM_SLICE)]


def fused_adam_kernel(theta, grads, mu, nu, count, ac: AdamConsts,
                      sched: LrSchedule, sizes):
    """Launch K4 (csrc/update.cu). Same contract as fused_adam_plain."""
    P = theta.numel()
    if sum(sizes) != P:
        raise ValueError(f"tensor sizes sum to {sum(sizes)}, the buffer has "
                         f"{P} floats")
    blocks = adam_blocks(P)
    for name, t in (("theta", theta), ("grads", grads), ("mu", mu),
                    ("nu", nu)):
        check_cuda_tensor(name, t, torch.float32, (P,))
    check_cuda_tensor("count", count, torch.float32, ())
    part = torch.empty(blocks, device=theta.device)  # the block sums
    consts = np.array([sched.lr, sched.total_steps, ac.b1, ac.b2, ac.eps,
                       ac.clip_norm, math.log(ac.b1), math.log(ac.b2)],
                      np.float32)
    fn = cuda_build.load("update").drone_fused_adam
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(theta.device):
        err = fn(theta.data_ptr(), grads.data_ptr(), mu.data_ptr(),
                 nu.data_ptr(), count.data_ptr(), part.data_ptr(), P, blocks,
                 consts.ctypes.data, int(sched.anneal),
                 torch.cuda.current_stream(theta.device).cuda_stream)
    cuda_build.check(err, "drone_fused_adam")
    fused_adam_cuda.launches += 1


def fused_adam_cuda(theta, grads, mu, nu, count, ac: AdamConsts,
                    sched: LrSchedule, sizes):
    """clip_by_global_norm + adam over the flat buffers, in place: the
    kernel on CUDA tensors, the plain version on CPU tensors. count is a
    0-d float32 tensor (the adam step count), incremented by one; sizes the
    element counts of the buffer's tensors in kernel order (the kernel
    sums the buffer by fixed slices, `adam_slices`, and needs them only for
    its check)."""
    run = fused_adam_plain if theta.device.type == "cpu" else fused_adam_kernel
    run(theta, grads, mu, nu, count, ac, sched, sizes)


fused_adam_cuda.launches = 0
