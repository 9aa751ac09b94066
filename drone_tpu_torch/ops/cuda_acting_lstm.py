"""Recurrent acting kernels: K8 (serving) and K6 (the training rollout).

Counterpart of `drone_tpu/ops/pallas_acting_lstm.py`. Both kernels are one
CUDA kernel, `csrc/acting_lstm.cu`, over the device functions of
`csrc/lstm.cuh`:

  - `lstm_act_rollout_cuda` (K8): T deterministic LSTM-policy + env steps,
    episode statistics and the final carry, evaluate()'s path for
    run.policy=lstm;
  - `traj_lstm_rollout_cuda` (K6): T stochastic steps streaming K2's
    (T, 21, N) trajectory planes (`cuda_acting_traj`'s TP_* layout) and the
    (c, h) anchor entering the first step of every bptt segment, (S, 2, H,
    N), the recurrent trainer's rollout.

Their plain PyTorch versions sit beside them: the encoder + LSTM cell of
`models.lstm.lstm_step` on the batch, the heads, K2's noise and log-prob,
the env step, then the carry of lanes that ended an episode zeroed
(ppo_rnn._mask_carry). The wrappers take the plain version for CPU
tensors only; on a CUDA tensor they launch the kernel.

The carry is the flax tuple (c, h), each (N, hidden), cell state first.
The policy is the flat parameter buffer in the reference's
`lstm_kernel_tensors` order (`models.lstm`) with its shape `arch` =
(hidden, encoder): the dense tower's widths, or the pixel-recurrent
family's patch-CNN `CnnArch`. `encode_features` is the reference's switch
between the two (`pallas_acting_lstm.encode_features`): the tanh dense
stack, or `cuda_acting_cnn.cnn_encode` (render, conv0, conv1, trunk in the
CNN kernels' formulation). The kernel runs, on tiles of 64 lanes
(`cuda_acting_cnn.TILE`) in both arms, the gate block on the tensor cores
in 3xTF32 (`csrc/lstm_mma.cuh`: the product (x; h) [Wi; Wh] in one,
`gate_linear` the plain version's hook for an emulation), after the dense
encoder on the fp32 cores or the CNN arm's tower on the tensor cores
(`csrc/cnn_mma.cuh`, K11's and the updates'); the CNN arm takes the
reference trainer's default tower only (`cuda_acting_cnn.KERNEL_ARCH`). The
wrapper packs the gate weights for the kernel (`pack_gates`) with torch ops
on the device, so a launch needs no host copy; the call then splits the
gates' (and the CNN arm's tower's) weights into their tensor-core fragments
on the launch's stream.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
from torch.nn import functional as F

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.models.lstm import (
    dense_encode,
    encoder_of,
    encoder_width,
    is_cnn,
    lstm_kernel_offsets,
    lstm_step,
    lstm_weights,
)
from drone_tpu_torch.ops import cuda_build
from drone_tpu_torch.ops.cuda_acting import gauss4
from drone_tpu_torch.ops.cuda_acting_cnn import (
    FWD_PACKED_FLOATS,
    KERNEL_ARCH,
    ROW_STRIDE,
    TOWER_FWD_SMEM,
    cnn_encode,
)
from drone_tpu_torch.ops.cuda_acting_traj import N_TRAJ, sample_logp
from drone_tpu_torch.ops.cuda_rollout import (
    N_STATS,
    accumulate,
    check_cuda_state,
    launch_planes,
    stats_dict,
)
from drone_tpu_torch.ppo_rnn import mask_carry
from drone_tpu_torch.pixels import grid_table, patch_grid
from drone_tpu_torch.types import OBS_DIM, EnvParams, EnvState, EnvStatics

# kernel limits (csrc/lstm.cuh, csrc/acting_lstm.cu)
MAX_ENC = 4
MAX_HIDDEN = 128
NET_INTS = 5 + 2 * MAX_ENC
ENC_DENSE, ENC_CNN = 0, 1  # the kernels' encoder arms (lstm.cuh)
# dynamic shared memory one H100 block can use, less the env params' copy
_MAX_SMEM = 232448 - 256


def enc_flat(enc):
    """The encoder's (W, b) pairs as one tuple (W0, b0, W1, b1, ...), the
    order cnn_encode takes (the reference's enc_flat)."""
    return tuple(t for pair in enc for t in pair)


def encode_features(encoder, device, compute_dtype: str = "float32"):
    """The encoder of `lstm_step` for this encoder kind (the reference's
    encode_features; its lstm_encoder_kind is `models.lstm.is_cnn` of the
    arch's encoder): (obs (N, 13), enc pairs) -> activations whose last is
    the LSTM input. The CNN's are cnn_encode's (sp, X0, Y0, Y1, X2, h),
    rendered on the host-built pixel grid. compute_dtype: the products'
    operands (bfloat16: K7's bf16 arm)."""
    if not is_cnn(encoder):
        return functools.partial(dense_encode, compute_dtype=compute_dtype)
    gx, gy = patch_grid(encoder.res, encoder.p0, device)

    def encode(obs, enc):
        return cnn_encode(obs, enc_flat(enc), gx, gy, encoder.geom, True,
                          compute_dtype)[1]

    return encode


def lstm_value(obs, carry, theta, hidden, encoder):
    """The critic's value at obs (N, 13) given the carry (c, h) entering the
    step (ppo_rnn_pallas._lstm_value): (N,)."""
    weights = lstm_weights(theta, hidden, encoder)
    *_, h2 = lstm_step(obs, carry[0], carry[1], weights,
                       encode_features(encoder_of(encoder), obs.device))
    vw, vb = weights[5]
    return F.linear(h2, vw, vb)[:, 0]


def net_layout(hidden: int, encoder) -> np.ndarray:
    """The host ints of csrc/lstm.cuh's LstmNet: [n_enc, H, enc widths,
    enc W offsets, head_off, vhead_off, ls_off]; the CNN tower counts as no
    dense layer (its offsets are cnn.cuh's). Raises for a policy the
    kernels cannot take."""
    encoder = encoder_of(encoder)
    hidden = int(hidden)
    if is_cnn(encoder) and tuple(encoder) != tuple(KERNEL_ARCH):
        raise ValueError(f"the LSTM kernels' CNN arm takes the tower "
                         f"{KERNEL_ARCH} only (CNNLSTMActorCritic's "
                         f"defaults), got {encoder}")
    dense = () if is_cnn(encoder) else encoder
    if len(dense) > MAX_ENC or hidden > MAX_HIDDEN or hidden % 4:
        raise ValueError(f"the LSTM kernels take at most {MAX_ENC} encoder "
                         f"layers and a hidden width <= {MAX_HIDDEN} that is a "
                         f"multiple of 4, got encoder {encoder}, hidden "
                         f"{hidden}")
    offs, _ = lstm_kernel_offsets(hidden, encoder)
    ints = np.zeros(NET_INTS, np.int32)
    ints[0], ints[1] = len(dense), hidden
    ints[2:2 + len(dense)] = dense
    ints[2 + MAX_ENC:2 + MAX_ENC + len(dense)] = [
        offs[f"enc_h{i}.weight"] for i in range(len(dense))]
    ints[2 + 2 * MAX_ENC:] = (offs["actor_mean.weight"],
                              offs["critic_value.weight"], offs["log_std"])
    return ints


def gate_units(hidden: int) -> int:
    """The gate block's units: hidden rounded up to a multiple of 8
    (csrc/lstm_mma.cuh gate_units; the padding units are zero)."""
    return -(-int(hidden) // 8) * 8


def gate_inputs(width: int) -> int:
    """The gate block's input rows: the LSTM's input width rounded up to a
    multiple of 8 (csrc/lstm_mma.cuh gate_inputs; the padding rows are
    zero)."""
    return -(-int(width) // 8) * 8


def gate_packed_floats(hidden: int, encoder) -> int:
    """Floats of the packed gate fragments: (Ep + Hp) x 4 Hp weights, big
    and small (csrc/lstm_mma.cuh gate_frags)."""
    hp = gate_units(hidden)
    return 2 * (gate_inputs(encoder_width(encoder_of(encoder))) + hp) * 4 * hp


def act_smem_bytes(hidden: int, encoder) -> int:
    """Shared memory of one acting block (acting_lstm.cu act_smem_bytes),
    rows of the tile at the tensor-core tiles' stride: the dense arm's obs,
    encoder buffers, x (Ep rows), h and c (Hp rows each); the CNN arm's
    tower forward tile, then h and c; both then the heads' 5 rows and
    keep's."""
    encoder = encoder_of(encoder)
    hc = 2 * gate_units(hidden) + 6
    if is_cnn(encoder):
        return TOWER_FWD_SMEM + 4 * ROW_STRIDE * hc
    mid = encoder[:-1]
    nbuf = min(len(mid), 2)
    return 4 * ROW_STRIDE * (OBS_DIM + nbuf * max(mid, default=0)
                             + gate_inputs(encoder_width(encoder)) + hc)


def check_act_envelope(hidden: int, encoder) -> None:
    """Raise ValueError for a policy K8 and K6 cannot take (net_layout's
    limits and a block's shared memory). evaluate() asks this before it
    picks K8."""
    net_layout(hidden, encoder)
    if act_smem_bytes(hidden, encoder) > _MAX_SMEM:
        raise ValueError(f"an LSTM of hidden {hidden} and encoder "
                         f"{encoder_of(encoder)} needs more shared memory per "
                         f"block than an H100 has")


def pack_gates(theta: torch.Tensor, hidden: int, encoder):
    """The gate weights as the kernels read them: WP (E + H, H, 4), the
    input-gate kernels' rows then the recurrent ones', each unit's 4 gates
    (i, f, g, o) together; BP (H, 4) the recurrent biases."""
    _, wi, wh, bh, *_ = lstm_weights(theta, hidden, encoder)
    W = torch.cat([torch.stack(wi), torch.stack(wh)], dim=2)  # (4, H, E + H)
    return (W.permute(2, 1, 0).contiguous(),
            torch.stack(bh, 1).contiguous())


@torch.no_grad()
def lstm_act_rollout_plain(state: EnvState, theta, arch, carry,
                           env_params: EnvParams, statics: EnvStatics,
                           T: int):
    """Plain PyTorch version of K8. Returns (final EnvState, final carry,
    per-lane statistics (N_STATS, N))."""
    torch.backends.cuda.matmul.allow_tf32 = False
    weights = lstm_weights(theta, *arch)
    encode = encode_features(encoder_of(arch[1]), state.pos.device)
    hw, hb = weights[4]
    acc = torch.zeros(N_STATS, state.n, device=state.pos.device)
    for _ in range(T):
        *_, c2, _, h2 = lstm_step(env_mod.observe(state), *carry, weights,
                                  encode)
        state, out = env_mod.step(state, F.linear(h2, hw, hb), env_params,
                                  statics)
        carry = mask_carry((c2, h2), out.terminated | out.truncated)
        acc = accumulate(acc, out)
    return state, carry, acc


@torch.no_grad()
def traj_lstm_rollout_plain(state: EnvState, theta, arch, carry,
                            env_params: EnvParams, statics: EnvStatics,
                            T: int, bptt: int, stochastic: bool = True):
    """Plain PyTorch version of K6 (traj_lstm_rollout_reference). Returns
    (final EnvState, final carry, planes (T, N_TRAJ, N), anchors (T // bptt,
    2, H, N), per-lane statistics (N_STATS, N))."""
    torch.backends.cuda.matmul.allow_tf32 = False
    if bptt <= 0 or T % bptt:
        raise ValueError(f"the horizon {T} must be a multiple of bptt {bptt}")
    weights = lstm_weights(theta, *arch)
    hw, hb = weights[4]
    vw, vb = weights[5]
    ls = weights[6]
    dev = state.pos.device
    encode = encode_features(encoder_of(arch[1]), dev)
    planes = torch.empty(T, N_TRAJ, state.n, device=dev)
    snap = torch.empty(T // bptt, 2, arch[0], state.n, device=dev)
    acc = torch.zeros(N_STATS, state.n, device=dev)
    for t in range(T):
        if t % bptt == 0:
            snap[t // bptt] = torch.stack([carry[0].t(), carry[1].t()])
        obs = env_mod.observe(state)
        *_, c2, _, h2 = lstm_step(obs, *carry, weights, encode)
        m = F.linear(h2, hw, hb)
        v = F.linear(h2, vw, vb)[:, 0]
        z = gauss4(state) if stochastic else torch.zeros_like(m)
        a, logp = sample_logp(m, z, ls, stochastic)
        state, out = env_mod.step(state, a, env_params, statics)
        done = out.terminated | out.truncated
        planes[t] = torch.cat([obs.t(), a.t(), logp[None], v[None],
                               out.reward[None],
                               done.to(torch.float32)[None]])
        carry = mask_carry((c2, h2), done)
        acc = accumulate(acc, out)
    return state, carry, planes, snap, acc


def _check_carry(carry, n, hidden, device):
    for t in carry:
        if (t.shape != (n, hidden) or t.dtype != torch.float32
                or t.device != device):
            raise ValueError(f"the carry must be two float32 ({n}, {hidden}) "
                             f"tensors on {device}, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")


def _launch(state, theta, arch, carry, env_params, statics, T, bptt=None,
            stochastic=True):
    """Launch csrc/acting_lstm.cu: serving when bptt is None, else the
    training rollout. Returns (final EnvState, carry, planes or None,
    anchors or None, per-lane statistics)."""
    check_cuda_state(state)
    hidden, encoder = int(arch[0]), encoder_of(arch[1])
    dev = state.pos.device
    lstm_weights(theta, hidden, encoder)  # checks the length
    if (theta.device != dev or theta.dtype != torch.float32
            or not theta.is_contiguous()):
        raise ValueError("theta must be a contiguous float32 buffer on the "
                         "state's device")
    check_act_envelope(hidden, encoder)
    layout = net_layout(hidden, encoder)
    # fragments, written by the call on its stream
    pg = torch.empty(gate_packed_floats(hidden, encoder), device=dev)
    pk = grid = None
    if is_cnn(encoder):
        pk = torch.empty(FWD_PACKED_FLOATS, device=dev)
        grid = grid_table(encoder.res, encoder.p0, dev)
    n = state.n
    _check_carry(carry, n, hidden, dev)
    c_in, h_in = (t.contiguous() for t in carry)
    c_out, h_out = torch.empty_like(c_in), torch.empty_like(h_in)
    wp, bp = pack_gates(theta, hidden, encoder)
    planes = snap = None
    if bptt is not None:
        if bptt <= 0 or T % bptt:
            raise ValueError(f"the horizon {T} must be a multiple of bptt "
                             f"{bptt}")
        planes = torch.empty(T, N_TRAJ, n, device=dev)
        snap = torch.empty(T // bptt, 2, hidden, n, device=dev)
    fn = cuda_build.load("acting_lstm").drone_lstm_act_rollout
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

    def ptr(t):
        return None if t is None else t.data_ptr()

    final, lane_stats = launch_planes(
        fn, state, env_params, statics, T, theta.data_ptr(), wp.data_ptr(),
        bp.data_ptr(), c_in.data_ptr(), h_in.data_ptr(), c_out.data_ptr(),
        h_out.data_ptr(), ptr(planes), ptr(snap), pg.data_ptr(), ptr(pk),
        ptr(grid), layout.ctypes.data,
        ENC_CNN if is_cnn(encoder) else ENC_DENSE, int(stochastic),
        int(bptt or 0), act_smem_bytes(hidden, encoder))
    return final, (c_out, h_out), planes, snap, lane_stats


def lstm_act_rollout_kernel(state, theta, arch, carry, env_params, statics,
                            T):
    """Launch K8. Same contract as lstm_act_rollout_plain."""
    final, carry, _, _, lane_stats = _launch(state, theta, arch, carry,
                                             env_params, statics, T)
    lstm_act_rollout_cuda.launches += 1
    lstm_act_rollout_cuda.cnn_launches += is_cnn(arch[1])
    return final, carry, lane_stats


def traj_lstm_rollout_kernel(state, theta, arch, carry, env_params, statics,
                             T, bptt, stochastic=True):
    """Launch K6. Same contract as traj_lstm_rollout_plain."""
    out = _launch(state, theta, arch, carry, env_params, statics, T, bptt,
                  stochastic)
    traj_lstm_rollout_cuda.launches += 1
    traj_lstm_rollout_cuda.cnn_launches += is_cnn(arch[1])
    return out


def lstm_act_rollout_cuda(state: EnvState, theta, arch, carry,
                          env_params: EnvParams, statics: EnvStatics, T: int):
    """T deterministic LSTM-policy + env steps per lane: the kernel on a
    CUDA state, the plain version on a CPU state. arch = (hidden, encoder
    widths or CnnArch) of the flat buffer theta. Returns (final EnvState, final carry
    (c, h), stats dict)."""
    run = (lstm_act_rollout_plain if state.pos.device.type == "cpu"
           else lstm_act_rollout_kernel)
    final, carry, lane_stats = run(state, theta, arch, carry, env_params,
                                   statics, T)
    return final, carry, stats_dict(lane_stats)


# launches of either arm, and of the CNN arm alone
lstm_act_rollout_cuda.launches = 0
lstm_act_rollout_cuda.cnn_launches = 0


def traj_lstm_rollout_cuda(state: EnvState, theta, arch, carry,
                           env_params: EnvParams, statics: EnvStatics, T: int,
                           bptt: int, stochastic: bool = True):
    """T LSTM-policy + env steps per lane emitting the training planes and
    the truncated-BPTT anchors: the kernel on a CUDA state, the plain
    version on a CPU state. Returns (final EnvState, final carry, planes
    (T, N_TRAJ, N), anchors (T // bptt, 2, H, N), stats dict)."""
    run = (traj_lstm_rollout_plain if state.pos.device.type == "cpu"
           else traj_lstm_rollout_kernel)
    final, carry, planes, snap, lane_stats = run(
        state, theta, arch, carry, env_params, statics, T, bptt, stochastic)
    return final, carry, planes, snap, stats_dict(lane_stats)


traj_lstm_rollout_cuda.launches = 0
traj_lstm_rollout_cuda.cnn_launches = 0
