"""The precision and the layouts of the CNN kernels' tensor-core design
(csrc/cnn_mma.cuh: K10 and K7's CNN arm, and the acting kernels K11, K9
and the CNN arms of K8 and K6, whose gate block csrc/lstm_mma.cuh runs
there too).

The kernels run the patch-CNN tower's products in 3xTF32: each fp32
operand split into big = round-to-nearest TF32 (ties away, as
cvt.rna.tf32.f32) and small = the same of x - big, and big.big + big.small
+ small.big summed in fp32. `cuda_update_cnn.mm_3xtf32` is that product in
torch; here it takes the place of the tower's products in the plain K10 and
the plain K7 CNN arm, which must stay within the update's tolerance (each
gradient tensor and the stats within 1e-4 of their max |value|) of the
fp32 plain versions, which tests/test_torch_update_cnn.py and
tests/test_torch_cnn_lstm.py hold to drone_tpu. Likewise the plain K11 and
the plain K8's CNN arm, with their tower's and gate block's products
emulated, stay within the serving tolerance (rtol 2e-5 / atol 2e-6 over 3
steps, episode counts equal) of their fp32 selves, which
tests/test_torch_cnn.py and tests/test_torch_cnn_lstm.py hold to
drone_tpu. The inputs are made with numpy (or the env's seeded init) at a
few hundred samples of the default tower, the one the kernels take. The
kernels' shared memory, scratch rows, packed fragments and envelope are
mirrored in Python; the C entry points refuse a call whose byte counts
disagree.
"""
import math

import numpy as np
import pytest
import torch

from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import (
    CNNLSTMActorCritic,
    PatchCNNActorCritic,
    lstm_kernel_order,
)
from drone_tpu_torch.models import lstm as lstm_model
from drone_tpu_torch.ops import cuda_acting_cnn, cuda_acting_lstm
from drone_tpu_torch.ops import cuda_update_cnn, cuda_update_lstm
from drone_tpu_torch.types import default_params
from drone_tpu_torch.ops.cuda_acting_cnn import KERNEL_ARCH
from drone_tpu_torch.ops.cuda_acting_traj import N_TRAJ
from drone_tpu_torch.ops.cuda_update import UpdateConsts

MAX_SMEM = 232448        # bytes a block of an H100 can take
SM_SMEM = 233472         # bytes an SM has, 1 KB of it reserved per block


def _rna_reference(x):
    """cvt.rna.tf32.f32 of each float32 of x, by float64 arithmetic: the
    nearest multiple of 2^(e - 10), ties away from zero."""
    x = np.asarray(x, np.float64)
    e = np.floor(np.log2(np.abs(x)))
    q = 2.0 ** (e - 10)
    return np.sign(x) * np.floor(np.abs(x) / q + 0.5) * q


def test_tf32_split_rounds_as_cvt_rna():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096)
         ).astype(np.float32)
    # ties: the 13 bits below TF32's mantissa exactly half an ulp
    ties = (rng.integers(0x3F800000, 0x40000000, 64, dtype=np.int64)
            & ~0x1FFF | 0x1000).astype(np.int32).view(np.float32)
    x = np.concatenate([x, ties, -ties])
    big, small = cuda_update_cnn.tf32_split(torch.from_numpy(x))
    assert not (big.view(torch.int32) & 0x1FFF).any()
    assert not (small.view(torch.int32) & 0x1FFF).any()
    np.testing.assert_array_equal(big.numpy(), _rna_reference(x))
    np.testing.assert_array_equal(small.numpy(),
                                  _rna_reference(x - big.numpy()))
    # big + small keeps ~21 of x's 24 bits
    rel = np.abs((big + small).numpy().astype(np.float64) - x) / np.abs(x)
    assert rel.max() < 2.0 ** -20


def test_3xtf32_product_is_near_fp32():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 576)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((576, 128)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = float(exact.abs().max())
    err3 = float((cuda_update_cnn.mm_3xtf32(a, b).double() - exact).abs().max())
    big_a, _ = cuda_update_cnn.tf32_split(a)
    big_b, _ = cuda_update_cnn.tf32_split(b)
    err1 = float(((big_a @ big_b).double() - exact).abs().max())
    assert err3 < 1e-6 * scale < err1  # plain TF32 would not hold


def _emulate(monkeypatch):
    """The tower's products of the plain versions in 3xTF32."""
    mm = cuda_update_cnn.mm_3xtf32
    monkeypatch.setattr(cuda_acting_cnn, "tower_linear",
                        lambda x, w, b: mm(x, w.t()) + b)
    monkeypatch.setattr(cuda_update_cnn, "tower_mm", mm)


def _emulate_gates(monkeypatch):
    """The gate block's product of the plain LSTM cell in 3xTF32, as the
    acting kernels' CNN arm runs it: (x; h) [Wi; Wh] in one."""
    mm = cuda_update_cnn.mm_3xtf32

    def gate_linear(x, h, wi, wh):
        return mm(torch.cat([x, h], 1), torch.cat([wi, wh], 1).t())

    monkeypatch.setattr(lstm_model, "gate_linear", gate_linear)


def _acting_policy(model):
    """A flattened policy with actions of order 1 (an orthogonal action head
    of gain 1) and log_std -0.5, as the card's checks use."""
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        torch.nn.init.orthogonal_(model.actor_mean.weight, 1.0, generator=g)
        model.log_std.fill_(-0.5)
    model.flatten_()
    return model


def _serving_env():
    """hover/euler with 2-step episodes: every lane ends one inside T = 3."""
    return tenv.DroneEnv("hover", "euler", default_params("hover", horizon=2),
                         device="cpu")


def _within_serving_tolerance(got, want):
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-6)


def _planes(rng, T, n):
    """Trajectory planes of plausible magnitudes: obs (unit quaternion at
    rows 3..6), actions, log-probs, values, rewards, dones."""
    p = rng.standard_normal((T, N_TRAJ, n)).astype(np.float32)
    q = p[:, 3:7]
    p[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    p[:, 17] = -3.0 + 0.5 * p[:, 17]
    p[:, 20] = (rng.random((T, n)) < 0.1).astype(np.float32)
    adv = rng.standard_normal((2, T, n)).astype(np.float32)
    return torch.from_numpy(p), torch.from_numpy(adv)


def _within_update_tolerance(got, want, order):
    (gg, gs), (wg, ws) = got, want
    off = 0
    for name, shape in order:
        n = math.prod(shape)
        a, b = gg[off:off + n], wg[off:off + n]
        off += n
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-4 * scale, name
    assert float((gs - ws).abs().max()) <= 1e-4 * float(ws.abs().max())


def test_3xtf32_plain_k10_within_tolerance(monkeypatch):
    rng = np.random.default_rng(2)
    T, n = 2, 256
    planes, advret = _planes(rng, T, n)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = PatchCNNActorCritic()
    model.flatten_()
    co = UpdateConsts(0.2, 0.5, 0.5, 1.0 / (128 * T))
    args = (planes, advret, torch.tensor([1], dtype=torch.int32), model.flat,
            model.arch, co, 128, 0.001)
    want = cuda_update_cnn.ppo_cnn_update_plain(*args)
    _emulate(monkeypatch)
    got = cuda_update_cnn.ppo_cnn_update_plain(*args)
    assert not torch.equal(got[0], want[0])  # the emulation ran
    _within_update_tolerance(got, want, model.kernel_order())


def test_3xtf32_plain_k7_cnn_arm_within_tolerance(monkeypatch):
    rng = np.random.default_rng(3)
    T, n, bptt, H = 4, 128, 2, 128
    planes, advret = _planes(rng, T, n)
    snap = torch.from_numpy(
        0.3 * rng.standard_normal((T // bptt, 2, H, n)).astype(np.float32))
    with torch.random.fork_rng():
        torch.manual_seed(0)
        model = CNNLSTMActorCritic(H)
    model.flatten_()
    co = UpdateConsts(0.2, 0.5, 0.5, 1.0 / (n * T))
    args = (planes, advret, snap, torch.tensor([0], dtype=torch.int32),
            model.flat, (H, KERNEL_ARCH), co, 128, bptt, 0.001)
    want = cuda_update_lstm.lstm_update_plain(*args)
    _emulate(monkeypatch)
    got = cuda_update_lstm.lstm_update_plain(*args)
    assert not torch.equal(got[0], want[0])
    _within_update_tolerance(got, want, lstm_kernel_order(H, KERNEL_ARCH))


@pytest.mark.parametrize("stochastic", [False, True])
def test_3xtf32_plain_k11_within_serving_tolerance(monkeypatch, stochastic):
    n, T = 384, 3
    env = _serving_env()
    state = env.init_batch(2, n)
    model = _acting_policy(
        PatchCNNActorCritic(generator=torch.Generator().manual_seed(0)))
    args = (state, model.flat, model.arch, env.params, env.statics, T,
            stochastic)
    wf, ws = cuda_acting_cnn.cnn_act_rollout_plain(*args)
    _emulate(monkeypatch)
    gf, gs = cuda_acting_cnn.cnn_act_rollout_plain(*args)
    assert not torch.equal(gs, ws)  # the emulation ran
    _within_serving_tolerance((gf.fstate(), gs), (wf.fstate(), ws))
    assert float(gs[1].sum()) == float(ws[1].sum()) >= n


@pytest.mark.parametrize("hidden", [128, 36])
def test_3xtf32_plain_k8_cnn_arm_within_serving_tolerance(monkeypatch,
                                                         hidden):
    rng = np.random.default_rng(6)
    n, T = 256, 3
    env = _serving_env()
    state = env.init_batch(2, n)
    model = _acting_policy(CNNLSTMActorCritic(
        hidden, generator=torch.Generator().manual_seed(0)))
    carry = tuple(torch.from_numpy(
        0.5 * rng.standard_normal((n, hidden)).astype(np.float32))
        for _ in range(2))
    args = (state, model.flat, (hidden, KERNEL_ARCH), carry, env.params,
            env.statics, T)
    wf, wc, ws = cuda_acting_lstm.lstm_act_rollout_plain(*args)
    _emulate(monkeypatch)
    _emulate_gates(monkeypatch)
    gf, gc, gs = cuda_acting_lstm.lstm_act_rollout_plain(*args)
    assert not torch.equal(gc[1], wc[1])
    _within_serving_tolerance((gf.fstate(), *gc, gs), (wf.fstate(), *wc, ws))
    assert float(gs[1].sum()) == float(ws[1].sum()) >= n


@pytest.mark.parametrize("hidden", [128, 64, 36, 16])
def test_acting_kernels_shared_memory_and_fragments(hidden):
    """The byte counts the acting wrappers pass: K11 and K9 the tower's
    forward tile, two blocks an SM; the CNN arms of K8 and K6 that tile,
    then h and c over the gate block's units (hidden padded to 8) at the
    tile's row stride, one block; the gate weights' packed fragments."""
    A, L = cuda_acting_cnn, cuda_acting_lstm
    assert A.TOWER_FWD_SMEM == 4 * (A.W0_FRAG_FLOATS + 72 * 268) == 109952
    assert 2 * (A.TOWER_FWD_SMEM + 256 + 1024) <= SM_SMEM
    hp = L.gate_units(hidden)
    assert hp % 8 == 0 and hidden <= hp < hidden + 8
    smem = L.act_smem_bytes(hidden, KERNEL_ARCH)
    assert smem == A.TOWER_FWD_SMEM + 4 * 72 * 2 * hp <= MAX_SMEM - 256
    assert L.gate_packed_floats(hidden, KERNEL_ARCH) == 2 * (128 + hp) * 4 * hp
    if hidden == 128:
        assert smem == 183680
        assert L.gate_packed_floats(128, KERNEL_ARCH) == 2**18
    L.check_act_envelope(hidden, KERNEL_ARCH)


@pytest.mark.parametrize("hidden", [128, 64, 16])
def test_tower_kernels_shared_memory_and_scratch(hidden):
    """The byte counts the K7 wrapper passes (the walk, the tower's forward
    and backward) and K10's: within a block's limit, the forward two blocks
    an SM; the CNN arm's walk no longer holds the tower's window rows."""
    U, C = cuda_update_lstm, cuda_update_cnn
    walk, fwd, bwd = U.kernel_smem_bytes(hidden, KERNEL_ARCH)
    assert fwd == C.TOWER_FWD_SMEM == 109952 == 4 * (
        8192 + 72 * (12 + 2 * 64 + 2 * 64))
    assert bwd == C.TOWER_BWD_SMEM == 4 * 72 * (12 + 128 + 2 * 256 + 64)
    assert max(walk, fwd, bwd) <= MAX_SMEM
    assert 2 * (fwd + 1024) <= SM_SMEM
    assert walk == U.bptt_smem_bytes(hidden, KERNEL_ARCH) == 4 * 64 * max(
        128 + 2 * hidden, 6 * hidden + 128 + 6)
    assert U.kernel_smem_bytes(hidden, (64,))[1:] == [0, 0]
    U.check_envelope(hidden, KERNEL_ARCH)
    rows = U.scratch_rows(hidden, KERNEL_ARCH)
    assert rows[U.XS] == 13 + 128 + hidden and rows[U.DP] == 128
    assert rows[U.X2S] == 576
    # K10's scratch per chunk: X2 and dzt of at most MAX_SCRATCH samples
    tch = C.pick_chunk_steps(128, 16384)
    assert tch * 16384 <= C.MAX_SCRATCH and (tch * 16384) % C.TILE == 0
    assert C.FP_W == 645 + 8 and C.BP_W == 20608
    assert C.PACKED_FLOATS == 4 * (64 * 64 + 2 * 256 * 64 + 2 * 576 * 128) // 2
