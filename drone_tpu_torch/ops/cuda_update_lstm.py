"""Truncated-BPTT PPO update kernel (K7): one minibatch of the recurrent
policy's forward and hand-written backward through time.

Counterpart of `drone_tpu/ops/pallas_update_lstm.py`. The kernels are in
`csrc/update_lstm.cu`; `lstm_update_plain` is the plain PyTorch version,
a mirror of the reference's `_segment_grads`: from each segment's (c, h)
anchor, bptt forward steps, then the gates walked backward step by step
(hand-written, not autograd), with every segment of the minibatch folded
into the batch. `lstm_update_cuda` takes the plain version for CPU
tensors only; on a CUDA tensor it launches the kernels.

Semantics kept from the reference: a minibatch is row blocks of whole
lanes (sequences stay whole); the gradient entering step t through time is
masked by step t's own keep = 1 - done (the carry leaving step t was masked
before it entered step t + 1); dgf uses the masked c_in; the gradient stops
at the segment anchor, which is stored data; the anchors are the carries
after the previous step's reset mask (K6 writes them so).

The reference re-runs the forward from chunk-boundary carries (`pick_sc`)
because a segment's activations overflow a TPU core's VMEM; its gradients
do not depend on the chunking. On the card one segment's activations for
the whole minibatch fit in device memory (about 1.2 GB at 16,384 lanes x
16 steps, H 128, encoder (64,)), so the kernel stores them in a scratch the
wrapper allocates and runs one forward per step, not 1 + 1.375.

The kernels run the gate block, its input gradient [dx; dh] and the
weight-gradient products on the tensor cores in 3xTF32
(`csrc/lstm_mma.cuh`, `csrc/update_lstm.cu`); the plain version's forward
gate product is `models.lstm.gate_linear` and its backward products
`gate_mm`, hooks an emulation of that precision
(`cuda_update_cnn.mm_3xtf32`) can take the place of.

The CNN arm (the pixel-recurrent family, `arch` = (hidden, CnnArch)): the
gradient at the LSTM's input flows back through the trunk, conv1 and conv0
by `cuda_update_cnn.cnn_encoder_bwd`, as the reference's `_segment_grads`
calls `cnn_encoder_bwd`, with the patches re-rendered from the stored obs.
The plain version keeps only the tower's output x of each step and re-runs
the tower in chunks of PLAIN_CHUNK samples in the backward, so it never
holds conv0's output for a whole minibatch (~19 GB). The kernel's arm
stores x, the trunk's inputs X2 (576 rows a sample) and dzt (128) for one
segment, ~1.9 GB in all at 16,384 lanes x 16 steps (H 128). It runs the
tower's forward per segment before the walk through time and its backward
after it, both on the tensor cores in 3xTF32 (`csrc/cnn_mma.cuh`, shared
with K10), so the walk reads x as the dense arm reads its encoder's output
(update_lstm.cu).

Returns (grads (P,) in the flat kernel order, stat sums (N_UPSTATS,)) as
`cuda_update.ppo_update_cuda`: gradients are sums scaled by inv_m, and
log_std's is its stat sums ST_DLS* minus ent_coef.

`compute_dtype="bfloat16"` is the reference's bf16 operand arm of K7
(`_segment_grads` with `_dot32` at bfloat16), both encoders: every
product takes its operands rounded to bfloat16 (`cuda_acting_traj.operand`)
and sums in float32: the encoder's layers (or the CNN tower), the 8 gate
products, the heads, their weight gradients, dh' from the heads, the gate
weights' gradients and [dx; dh], and the encoder's backward (the CNN's by
`cnn_encoder_bwd`). The bias sums, the cell's elementwise math, the head's
subgradients and the stored activations stay float32. The kernels take it
as the `BF16` template parameter of the same kernels (update_lstm.cu).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.nn import functional as F

from drone_tpu_torch.models.lstm import (
    encoder_of,
    encoder_width,
    is_cnn,
    lstm_kernel_offsets,
    lstm_step,
    lstm_weights,
)
from drone_tpu_torch.ops import cuda_build
from drone_tpu_torch.ops.cuda_acting_cnn import ROW_STRIDE, TILE
from drone_tpu_torch.ops.cuda_acting_lstm import (
    ENC_CNN,
    ENC_DENSE,
    check_act_envelope,
    enc_flat,
    encode_features,
    gate_inputs,
    gate_packed_floats,
    gate_units,
    net_layout,
    pack_gates,
)
from drone_tpu_torch.ops.cuda_acting_traj import (
    N_TRAJ,
    TP_ACT0,
    TP_DONE,
    TP_LOGP,
    TP_OBS0,
    TP_VAL,
    bf16_flag,
    operand,
)
from drone_tpu_torch.ops.cuda_update import (
    N_UPSTATS,
    ST_DLS0,
    UpdateConsts,
    branch_counts,
    check_cuda_tensor,
    head_grads,
    minibatch_lanes,
)
from drone_tpu_torch.ops.cuda_update_cnn import (
    PLAIN_CHUNK,
    cnn_encoder_bwd,
    tower_layout,
)
from drone_tpu_torch.pixels import grid_table
from drone_tpu_torch.types import OBS_DIM

# kernel limits (csrc/update_lstm.cu, csrc/lstm_mma.cuh)
BP_LANES = TILE           # lanes of a through-time tile
MAX_CHUNK = 2048          # samples of one split-K chunk of the gradient products
# the products' operand tiles: A and B, 64 rows of 64 samples at a stride of
# 68 floats, double-buffered; the CNN arm's bf16 products' as bf16 rows of
# 72 (csrc/mma.cuh GB_SMEM); the dense arm's bf16 products' as rows of 36
# bf16x2 words beside A's fp32 rows for the bias sums (update_lstm.cu
# GR_SMEM)
PRODUCT_SMEM = 2 * 2 * 64 * 68 * 4
PRODUCT_SMEM_BF16 = 2 * 2 * 64 * 72 * 2
PRODUCT_SMEM_ROUNDED = 2 * 2 * 64 * 36 * 4 + 2 * 64 * 68 * 4
# the bf16 walk's operand rows: bf16 a row (csrc/cnn_mma.cuh TMB); its
# warps' rings of gate fragments, 4 k-tiles of 32 bytes a lane
# (csrc/lstm_mma.cuh B16_RING_BYTES)
B16_ROW = 72
WALK_RING_BYTES = 8 * (4 * 32 * 32)
_MAX_SMEM = 232448


def _forward_encode(encoder, device, compute_dtype):
    """The encoder of the plain version's forward: the dense tower's
    activations, or for the CNN only its output x, run PLAIN_CHUNK samples
    at a time (the backward re-runs the tower)."""
    full = encode_features(encoder, device, compute_dtype)
    if not is_cnn(encoder):
        return full

    def encode(obs, enc):
        return [torch.cat([full(o, enc)[-1] for o in obs.split(PLAIN_CHUNK)])]

    return encode


def _segments(x, S, bptt):
    """(T, ..., L) -> (bptt, ..., S * L): step j of every segment, the
    segments folded into the lane axis (segment-major)."""
    x = x.reshape(S, bptt, *x.shape[1:])
    x = x.movedim(0, -2)
    return x.reshape(bptt, *x.shape[1:-2], S * x.shape[-1])


def _segment_forward(planes, advret, snap, perm_mb, weights, arch, rbl,
                     bptt, compute_dtype):
    """The minibatch's segments run forward from their anchors, folded into
    the batch. Returns (planes (bptt, 21, B), advret (bptt, 2, B), per step
    (encoder activations, gates, c_in, h_in, tanh(c'), h', keep))."""
    hidden, encoder = int(arch[0]), encoder_of(arch[1])
    encode = _forward_encode(encoder, planes.device, compute_dtype)
    T = planes.shape[0]
    if bptt <= 0 or T % bptt:
        raise ValueError(f"the horizon {T} must be a multiple of bptt {bptt}")
    S = T // bptt
    lanes = minibatch_lanes(perm_mb, rbl)
    blk = _segments(planes[:, :, lanes], S, bptt)     # (bptt, 21, B)
    ar = _segments(advret[:, :, lanes].movedim(0, 1), S, bptt)  # (bptt, 2, B)
    anc = snap[:, :, :, lanes]                         # (S, 2, H, L)
    c = anc[:, 0].permute(0, 2, 1).reshape(-1, hidden)
    h = anc[:, 1].permute(0, 2, 1).reshape(-1, hidden)
    steps = []
    for t in range(bptt):
        pt = blk[t]
        acts, gates, c2, th, h2 = lstm_step(pt[TP_OBS0:TP_OBS0 + OBS_DIM].t(),
                                            c, h, weights, encode,
                                            compute_dtype)
        keep = (1.0 - pt[TP_DONE])[:, None]
        steps.append((acts, gates, c, h, th, h2, keep))
        c, h = c2 * keep, h2 * keep
    return blk, ar, steps


@torch.no_grad()
def lstm_head_branch_counts(planes, advret, snap, perm_mb, theta, arch,
                            co: UpdateConsts, rbl: int, bptt: int,
                            compute_dtype: str = "float32") -> dict:
    """cuda_update.head_branch_counts for the LSTM: how many samples of a
    minibatch take each branch of the head's subgradients at theta (the
    forward of compute_dtype's arm)."""
    bf16_flag(compute_dtype)
    weights = lstm_weights(theta, *arch)
    (hw, hb), (vw, vb), ls = weights[4:]
    blk, ar, steps = _segment_forward(planes, advret, snap, perm_mb, weights,
                                      arch, rbl, bptt, compute_dtype)
    h2 = operand(torch.cat([s[5] for s in steps]), compute_dtype)
    hw, vw = operand(hw, compute_dtype), operand(vw, compute_dtype)
    pt = blk.permute(1, 0, 2).reshape(N_TRAJ, -1)
    arf = ar.permute(1, 0, 2).reshape(2, -1)
    return branch_counts(F.linear(h2, hw, hb), F.linear(h2, vw, vb)[:, 0],
                         pt[TP_ACT0:TP_ACT0 + 4].t(), pt[TP_LOGP], pt[TP_VAL],
                         arf[0], arf[1], ls, co)


def gate_mm(a, b):
    """a @ b for the products the kernels run on the tensor cores in 3xTF32
    (dz [Wi; Wh]^T and the weight gradients over the samples);
    cuda_update_cnn.mm_3xtf32 can take its place."""
    return a @ b


@torch.no_grad()
def lstm_update_plain(planes, advret, snap, perm_mb, theta, arch,
                      co: UpdateConsts, rbl: int, bptt: int,
                      ent_coef: float = 0.0, compute_dtype: str = "float32"):
    """Plain PyTorch version of K7. planes (T, N_TRAJ, N) and anchors (T //
    bptt, 2, H, N) from the LSTM rollout; advret (2, T, N); perm_mb the
    minibatch's row blocks of rbl lanes; theta the flat parameters of arch
    = (hidden, encoder widths or CnnArch); compute_dtype the products'
    operands."""
    bf16_flag(compute_dtype)
    torch.backends.cuda.matmul.allow_tf32 = False

    def op(x):
        return operand(x, compute_dtype)

    hidden, encoder = int(arch[0]), encoder_of(arch[1])
    weights = lstm_weights(theta, hidden, encoder)
    enc, wi, wh, bh, (hw, hb), (vw, vb), ls = weights
    blk, ar, steps = _segment_forward(planes, advret, snap, perm_mb, weights,
                                      arch, rbl, bptt, compute_dtype)
    full_encode = encode_features(encoder, theta.device, compute_dtype)
    hw_r, vw_r = op(hw), op(vw)
    wi_r, wh_r = [op(w) for w in wi], [op(w) for w in wh]
    c = steps[0][2]
    grads = torch.zeros_like(theta)
    g_enc, g_wi, g_wh, g_bh, (g_hw, g_hb), (g_vw, g_vb), _ = lstm_weights(
        grads, hidden, encoder)
    st = torch.zeros(N_UPSTATS, device=theta.device)
    dh = torch.zeros_like(c)
    dc = torch.zeros_like(c)
    for t in range(bptt - 1, -1, -1):
        acts, (gi, gf, gg, go), c_in, h_in, th, h2, keep = steps[t]
        pt = blk[t]
        h2r = op(h2)
        m = F.linear(h2r, hw_r, hb)
        v = F.linear(h2r, vw_r, vb)[:, 0]
        dm, g_v, stats = head_grads(
            m, v, pt[TP_ACT0:TP_ACT0 + 4].t(), pt[TP_LOGP], pt[TP_VAL],
            ar[t, 0], ar[t, 1], ls, co)
        st += stats.sum(0)
        dmr, g_vr = op(dm), op(g_v)
        g_hw += gate_mm(dmr.t(), h2r)
        g_hb += dm.sum(0)
        g_vw += gate_mm(g_vr[None], h2r)
        g_vb += g_v.sum(0, keepdim=True)
        dh2 = dmr @ hw_r + g_vr[:, None] @ vw_r + dh * keep
        dc2 = dc * keep + dh2 * go * (1.0 - th * th)
        dgo = dh2 * th
        dgi = dc2 * gg
        dgf = dc2 * c_in
        dgg = dc2 * gi
        dc = dc2 * gf
        dz = (dgi * (gi * (1.0 - gi)), dgf * (gf * (1.0 - gf)),
              dgg * (1.0 - gg * gg), dgo * (go * (1.0 - go)))
        x, h_inr = op(acts[-1]), op(h_in)
        dh = torch.zeros_like(dh)
        dx = torch.zeros_like(x)
        for k in range(4):
            dzr = op(dz[k])
            g_wi[k] += gate_mm(dzr.t(), x)
            g_wh[k] += gate_mm(dzr.t(), h_inr)
            g_bh[k] += dz[k].sum(0)
            dh = dh + gate_mm(dzr, wh_r[k])
            dx = dx + gate_mm(dzr, wi_r[k])
        if is_cnn(encoder):
            # the tower re-run a chunk at a time, and its backward
            obs = pt[TP_OBS0:TP_OBS0 + OBS_DIM].t()
            for s0 in range(0, obs.shape[0], PLAIN_CHUNK):
                sl = slice(s0, s0 + PLAIN_CHUNK)
                g = cnn_encoder_bwd(dx[sl], full_encode(obs[sl], enc),
                                    enc_flat(enc), encoder.geom,
                                    compute_dtype)
                for dst, src in zip(enc_flat(g_enc), g):
                    dst += src
            continue
        for li in range(len(enc) - 1, -1, -1):
            y = acts[li + 1]
            dpre = dx * (1.0 - y * y)
            g_enc[li][0].add_(gate_mm(op(dpre).t(), op(acts[li])))
            g_enc[li][1].add_(dpre.sum(0))
            if li > 0:
                dx = op(dpre) @ op(enc[li][0])
    offs, _ = lstm_kernel_offsets(hidden, encoder)
    grads[offs["log_std"]:offs["log_std"] + 4] = st[ST_DLS0:] - ent_coef
    return grads, st


# scratch buffers of one segment, each (bptt, rows, NL): the forward's
# activations [X, encoder outputs, h_in], dz, the gate block's [gi, gf, gg,
# go, c_in, tanh(c')] over its padded units (in its threads' order; the bf16
# walk's without tanh(c')), h',
# the heads' outputs (then their gradients [dm, g_v]), the dense encoder's
# dpre or the CNN arm's dzt, and the CNN arm's trunk inputs X2
XS, GZ, GF, H2, DMV, DP, X2S = range(7)


def grad_products(hidden: int, encoder):
    """The weight-gradient products of csrc/update_lstm.cu and where their
    sums go. Returns (pairs int32 (n, 7): [A buffer, A row0, M, B buffer, B
    row0, N, out offset], each the (M, N + 1) block sum_s A[m, s] B[n, s]
    with the bias sums sum_s A[m, s] as column N; their total size; the map
    (P,) int32 from each flat parameter to its sum, -1 - k for log_std[k]).
    The CNN arm's gW0, gb0, gW1, gb1 come first, in the flat buffer's
    order: tower_bwd_kernel writes them into each row's first OFF_WT
    columns; its gWt and gbt are the product dzt x X2.
    """
    encoder = encoder_of(encoder)
    H = int(hidden)
    E = encoder_width(encoder)
    offs, P = lstm_kernel_offsets(H, encoder)
    mp = np.zeros(P, np.int64)
    pairs, out = [], 0

    def place(w_off, b_off, M, N, out, w_cols=None, col0=0):
        """W (M, w_cols) at w_off from columns col0.. of the block, b from
        column N."""
        w_cols = N if w_cols is None else w_cols
        rows = out + np.arange(M)[:, None] * (N + 1)
        if w_off is not None:
            mp[w_off:w_off + M * w_cols] = (rows + col0
                                            + np.arange(w_cols)).reshape(-1)
        if b_off is not None:
            mp[b_off:b_off + M] = rows[:, 0] + N

    if is_cnn(encoder):
        out = offs["trunk.weight"]
        mp[:out] = np.arange(out)
        nx2 = _x2_rows(encoder)
        pairs.append((DP, 0, E, X2S, 0, nx2, out))
        place(offs["trunk.weight"], offs["trunk.bias"], E, nx2, out)
        out += E * (nx2 + 1)
        x_row = OBS_DIM
    else:
        x_row = OBS_DIM + sum(encoder) - E if encoder else 0
        in_row, nin, dp_row = 0, OBS_DIM, 0
        for i, e in enumerate(encoder):
            pairs.append((DP, dp_row, e, XS, in_row, nin, out))
            place(offs[f"enc_h{i}.weight"], offs[f"enc_h{i}.bias"], e, nin,
                  out)
            out += e * (nin + 1)
            in_row = OBS_DIM + dp_row
            dp_row += e
            nin = e
    pairs.append((GZ, 0, 4 * H, XS, x_row, E + H, out))
    for g, gate in enumerate("ifgo"):
        blk = out + g * H * (E + H + 1)
        place(offs[f"lstm.i{gate}.weight"], None, H, E + H, blk, E)
        place(offs[f"lstm.h{gate}.weight"], offs[f"lstm.h{gate}.bias"], H,
              E + H, blk, H, E)
    out += 4 * H * (E + H + 1)
    pairs.append((DMV, 0, 5, H2, 0, H, out))
    place(offs["actor_mean.weight"], offs["actor_mean.bias"], 4, H, out)
    place(offs["critic_value.weight"], offs["critic_value.bias"], 1, H,
          out + 4 * (H + 1))
    out += 5 * (H + 1)
    mp[offs["log_std"]:offs["log_std"] + 4] = -1 - np.arange(4)
    return np.array(pairs, np.int32), out, mp.astype(np.int32)


def _x2_rows(arch) -> int:
    """The trunk's input width: conv1's windows x channels (576)."""
    return arch.geom.n_q1 * arch.c1


def scratch_rows(hidden: int, encoder,
                 compute_dtype: str = "float32") -> list[int]:
    """Rows per step of each scratch buffer (XS, GZ, GF, H2, DMV, DP, X2S);
    the bf16 walk keeps five of GF's six quantities, recomputing tanh(c')
    (update_lstm.cu GF_B16)."""
    encoder = encoder_of(encoder)
    gf = (5 if bf16_flag(compute_dtype) else 6) * gate_units(hidden)
    if is_cnn(encoder):
        E = encoder.hidden
        return [OBS_DIM + E + hidden, 4 * hidden, gf, hidden, 5, E,
                _x2_rows(encoder)]
    enc_rows = sum(encoder)
    return [OBS_DIM + enc_rows + hidden, 4 * hidden, gf, hidden, 5, enc_rows,
            0]


def bptt_smem_bytes(hidden: int, encoder,
                    compute_dtype: str = "float32") -> int:
    """Shared memory of one through-time block (update_lstm.cu
    bptt_smem_floats): the larger of the forward's (the dense arm's obs and
    encoder buffers at 64 floats a row, x (Ep rows) and h (Hp rows) at the
    tensor-core tiles' stride; the CNN arm reads x from the scratch) and
    the backward's (dz (4 Hp rows), dx (the larger of Ep and the widest
    layer), [dm; g_v] and keep at that stride). c, dh and dc live in
    registers. The bf16 walk keeps x, h and dz as bf16 rows of B16_ROW
    (x's and h's rows padded with zero rows to a multiple of 16; the dense
    arm's last encoder layer also in fp32 rows of 64, the CNN arm's next x
    too, and dz's region at least the fp32 rows of the layers before the
    last), and its warps' fragment rings (WALK_RING_BYTES) after x and h
    (over the dense encoder's rows) and after dz."""
    encoder = encoder_of(encoder)
    E = encoder_width(encoder)
    ep, hp = gate_inputs(E), gate_units(hidden)
    mid = () if is_cnn(encoder) else encoder[:-1]
    maxw = max(mid, default=0)
    maxe = E if is_cnn(encoder) else max(encoder, default=0)
    rows = 4 * ROW_STRIDE * (max(ep, maxe) + 6)  # dx, [dm; g_v], keep
    dense = 0 if is_cnn(encoder) else 4 * BP_LANES * (
        OBS_DIM + min(len(mid), 2) * maxw)
    if bf16_flag(compute_dtype):
        ring = WALK_RING_BYTES
        x_h = 2 * B16_ROW * gate_k16(hidden, encoder)
        fwd = x_h + (4 * BP_LANES * E + ring if is_cnn(encoder) else max(
            dense + (4 * BP_LANES * E if encoder else 0), ring))
        return max(fwd, max(2 * B16_ROW * 4 * hp + ring,
                            4 * ROW_STRIDE * maxw) + rows)
    return max(4 * ROW_STRIDE * (ep + hp) + dense,
               4 * ROW_STRIDE * 4 * hp + rows)


def kernel_smem_bytes(hidden: int, encoder,
                      compute_dtype: str = "float32") -> list[int]:
    """Shared bytes of a block of each kernel the C entry point launches
    with dynamic shared memory, as it checks them: the walk through time,
    the CNN arm's tower forward and backward (0 for the dense arm), and the
    products; under bfloat16 each is its bf16 design's."""
    cnn = is_cnn(encoder_of(encoder))
    fwd, bwd, _, _ = tower_layout(compute_dtype)
    products = PRODUCT_SMEM
    if bf16_flag(compute_dtype):
        products = PRODUCT_SMEM_BF16 if cnn else PRODUCT_SMEM_ROUNDED
    return [bptt_smem_bytes(hidden, encoder, compute_dtype),
            fwd if cnn else 0, bwd if cnn else 0, products]


def gate_t_packed_floats(hidden: int, encoder) -> int:
    """Floats of the transposed gate fragments of the walk's backward
    product: 4 Hp x (Ep + Hp) weights, big and small (csrc/lstm_mma.cuh
    gate_t_frags)."""
    hp = gate_units(hidden)
    return 2 * 4 * hp * (gate_inputs(encoder_width(encoder_of(encoder))) + hp)


def gate_k16(hidden: int, encoder) -> int:
    """The bf16 walk's forward product's rows: Ep + Hp rounded up to a
    multiple of 16 (update_lstm.cu gate_k16)."""
    ep = gate_inputs(encoder_width(encoder_of(encoder)))
    return -(-(ep + gate_units(hidden)) // 16) * 16


def gate_fragment_bytes(hidden: int, encoder,
                        compute_dtype: str = "float32") -> tuple[int, int]:
    """Bytes of the walk's forward and transposed gate fragments: the fp32
    arm's (big, small) float4s, or the bf16 arm's bf16x2 words, each weight
    once as bf16 (a quarter; the forward's zero rows to a multiple of 16
    beside them: update_lstm.cu pack_gates_b16_kernel,
    pack_gates_t_b16_kernel)."""
    if bf16_flag(compute_dtype):
        hp = gate_units(hidden)
        return 2 * gate_k16(hidden, encoder) * 4 * hp, \
            gate_t_packed_floats(hidden, encoder)
    return (4 * gate_packed_floats(hidden, encoder),
            4 * gate_t_packed_floats(hidden, encoder))


def check_envelope(hidden: int, encoder,
                   compute_dtype: str = "float32") -> None:
    """Raise ValueError for an LSTM that K6, K7 or K8 cannot take: at most
    MAX_ENC encoder layers none wider than 4 x hidden (or the CNN arm's one
    tower), a hidden width <= MAX_HIDDEN that is a multiple of 4, and the
    shared memory of a block (K7's compute_dtype arm's)."""
    encoder = encoder_of(encoder)
    check_act_envelope(hidden, encoder)
    if not is_cnn(encoder) and max(encoder, default=0) > 4 * hidden:
        raise ValueError(f"encoder widths above 4 x hidden ({4 * hidden}) do "
                         f"not fit the update kernel's buffers, got "
                         f"{list(encoder)}")
    if max(kernel_smem_bytes(hidden, encoder, compute_dtype)) > _MAX_SMEM:
        raise ValueError(f"an LSTM of hidden {hidden} and encoder "
                         f"{encoder} needs more shared memory per block "
                         f"than an H100 has")


def chunk_lanes(NL: int) -> int:
    """Lanes of one split-K chunk: the largest power of two up to MAX_CHUNK
    that divides the minibatch's lanes."""
    ck = MAX_CHUNK
    while NL % ck:
        ck //= 2
    return ck


_maps: dict = {}


def _device_map(hidden, encoder, device):
    """The flat-parameter map of grad_products on the device, made once per
    shape (through pinned memory, so the copy does not wait for the
    stream)."""
    key = (hidden, encoder_of(encoder), str(device))
    if key not in _maps:
        pairs, ptot, mp = grad_products(hidden, encoder)
        _maps[key] = (pairs, ptot, torch.from_numpy(mp).pin_memory().to(
            device, non_blocking=True))
    return _maps[key]


def lstm_update_kernel(planes, advret, snap, perm_mb, theta, arch,
                       co: UpdateConsts, rbl: int, bptt: int,
                       ent_coef: float = 0.0, compute_dtype: str = "float32"):
    """Launch K7 (csrc/update_lstm.cu; its bf16 arm under bfloat16). Same
    contract as lstm_update_plain."""
    bf16 = bf16_flag(compute_dtype)
    hidden, encoder = int(arch[0]), encoder_of(arch[1])
    T, _, n = planes.shape
    layout = net_layout(hidden, encoder)
    if bptt <= 0 or T % bptt:
        raise ValueError(f"the horizon {T} must be a multiple of bptt {bptt}")
    if rbl % 128 or n % rbl:
        raise ValueError(f"row blocks of {rbl} lanes: the kernel needs a "
                         f"multiple of 128 that divides {n}")
    check_envelope(hidden, encoder, compute_dtype)
    S = T // bptt
    _, P = lstm_kernel_offsets(hidden, encoder)
    check_cuda_tensor("planes", planes, torch.float32, (T, N_TRAJ, n))
    check_cuda_tensor("advret", advret, torch.float32, (2, T, n))
    check_cuda_tensor("snap", snap, torch.float32, (S, 2, hidden, n))
    check_cuda_tensor("perm_mb", perm_mb, torch.int32, (perm_mb.numel(),))
    check_cuda_tensor("theta", theta, torch.float32, (P,))
    dev = planes.device
    NL = perm_mb.numel() * rbl
    CK = chunk_lanes(NL)
    nk = bptt * NL // CK
    nblk = NL // BP_LANES
    pairs, ptot, mp = _device_map(hidden, encoder, dev)
    wp, bp = pack_gates(theta, hidden, encoder)
    rows = scratch_rows(hidden, encoder, compute_dtype)
    scratch = [torch.empty(max(r, 1) * bptt * NL, device=dev) for r in rows]
    partial = torch.empty(S * nk, ptot, device=dev)
    stat_part = torch.empty(S * nblk, N_UPSTATS, device=dev)
    grads = torch.empty(P, device=dev)
    stats = torch.empty(N_UPSTATS, device=dev)
    cnn = is_cnn(encoder)
    if cnn:
        pk = torch.empty(tower_layout(compute_dtype)[2], device=dev)
        grid = grid_table(encoder.res, encoder.p0, dev)
    # the gate weights' fragments, written by the call on its stream
    pg, pgt = (torch.empty(b // 4, device=dev) for b in
               gate_fragment_bytes(hidden, encoder, compute_dtype))
    # the bf16 arm's copy of theta with the walk's weights rounded
    theta16 = torch.empty(P, device=dev) if bf16 else None
    ptrs = np.array([t.data_ptr() for t in (
        planes, advret, snap, perm_mb, theta, wp, bp, *scratch, partial,
        stat_part, mp, grads, stats)]
        + ([pk.data_ptr(), grid.data_ptr()] if cnn else [0, 0])
        + [pg.data_ptr(), pgt.data_ptr(),
           theta16.data_ptr() if bf16 else 0], np.uint64)
    dims = np.array([n, T, bptt, rbl, NL, CK, P, ptot, len(pairs), *rows,
                     *kernel_smem_bytes(hidden, encoder, compute_dtype),
                     bf16], np.int32)
    consts = np.array([co.inv_m, 1.0 - co.clip_eps, 1.0 + co.clip_eps,
                       co.clip_eps, co.vf_clip, 0.5 * co.vf_coef, ent_coef],
                      np.float32)
    fn = cuda_build.load("update_lstm").drone_lstm_update
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(ptrs.ctypes.data, layout.ctypes.data,
                 ENC_CNN if cnn else ENC_DENSE, dims.ctypes.data,
                 np.ascontiguousarray(pairs).ctypes.data, consts.ctypes.data,
                 torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "drone_lstm_update")
    lstm_update_cuda.launches += 1
    lstm_update_cuda.cnn_launches += cnn
    lstm_update_cuda.bf16_launches += bf16
    return grads, stats


def lstm_update_cuda(planes, advret, snap, perm_mb, theta, arch,
                     co: UpdateConsts, rbl: int, bptt: int,
                     ent_coef: float = 0.0, compute_dtype: str = "float32"):
    """One recurrent PPO minibatch gradient pass (truncated BPTT): the
    kernels on CUDA tensors, the plain version on CPU tensors. perm_mb:
    (n_sel,) int32 row-block indices, block i covering lanes [i*rbl,
    (i+1)*rbl). compute_dtype: "float32" or "bfloat16" (the bf16 operand
    arm); ValueError for another. Returns (grads (P,), stat sums (8,))."""
    run = lstm_update_plain if planes.device.type == "cpu" else lstm_update_kernel
    return run(planes, advret, snap, perm_mb, theta, arch, co, rbl, bptt,
               ent_coef, compute_dtype)


# launches of any arm; of the CNN arm alone; of the bf16 arms alone
lstm_update_cuda.launches = 0
lstm_update_cuda.cnn_launches = 0
lstm_update_cuda.bf16_launches = 0
