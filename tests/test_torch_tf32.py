"""The precision and the layouts of the kernels' tensor-core design
(csrc/cnn_mma.cuh: K10 and K7's CNN arm, and the acting kernels K11, K9
and the CNN arms of K8 and K6; csrc/lstm_mma.cuh: the LSTM gate block of
K8, K6 and K7 in both arms, K7's [dx; dh] product and its weight-gradient
products; csrc/update.cu and csrc/acting.cu: the MLP towers of K3 and
K5).

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
drone_tpu. The dense arms of K8 and K7, whose gate block (and K7's
products) run there too, are held the same way with `models.lstm.
gate_linear` and `cuda_update_lstm.gate_mm` emulated, and the MLP's K3 and
K5 with `cuda_update.tower_mm` and `models.mlp.ActorCritic._dense`
emulated (tests/test_torch_update.py and tests/test_torch_cuda_acting.py
hold their fp32 selves to drone_tpu). The inputs are made
with numpy (or the env's seeded init) at a few hundred samples of the
default tower, the one the kernels take. The kernels' shared memory,
scratch rows, packed fragments and envelope are mirrored in Python; the C
entry points refuse a call whose byte counts disagree.
"""
import math

import numpy as np
import pytest
import torch

from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import (
    ActorCritic,
    CNNLSTMActorCritic,
    LSTMActorCritic,
    PatchCNNActorCritic,
    kernel_offsets,
    kernel_order,
    lstm_kernel_order,
)
from drone_tpu_torch.models import lstm as lstm_model
from drone_tpu_torch.ops import cuda_acting, cuda_acting_cnn, cuda_acting_lstm
from drone_tpu_torch.ops import cuda_update, cuda_update_cnn, cuda_update_lstm
from drone_tpu_torch.types import default_params
from drone_tpu_torch.ops.cuda_acting_cnn import KERNEL_ARCH
from drone_tpu_torch.ops.cuda_acting_traj import N_TRAJ
from drone_tpu_torch.ops.cuda_update import UpdateConsts

MAX_SMEM = 232448        # bytes a block of an H100 can take
SM_SMEM = 233472         # bytes an SM has, 1 KB of it reserved per block


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _emulate_gate_mm(monkeypatch):
    """The products K7 runs on the tensor cores in 3xTF32 besides the gate
    block: [dx; dh] and the weight gradients over the samples."""
    monkeypatch.setattr(cuda_update_lstm, "gate_mm", cuda_update_cnn.mm_3xtf32)


@pytest.mark.parametrize("hidden", [128, 36])
def test_3xtf32_plain_k7_dense_within_tolerance(monkeypatch, hidden):
    rng = np.random.default_rng(7)
    T, n, bptt, encoder = 4, 128, 2, (64,)
    planes, advret = _planes(rng, T, n)
    snap = torch.from_numpy(
        0.3 * rng.standard_normal((T // bptt, 2, hidden, n)).astype(np.float32))
    model = LSTMActorCritic(hidden, encoder,
                            generator=torch.Generator().manual_seed(0))
    model.flatten_()
    co = UpdateConsts(0.2, 0.5, 0.5, 1.0 / (n * T))
    args = (planes, advret, snap, torch.tensor([0], dtype=torch.int32),
            model.flat, (hidden, encoder), co, 128, bptt, 0.001)
    want = cuda_update_lstm.lstm_update_plain(*args)
    _emulate_gates(monkeypatch)
    _emulate_gate_mm(monkeypatch)
    got = cuda_update_lstm.lstm_update_plain(*args)
    assert not torch.equal(got[0], want[0])
    _within_update_tolerance(got, want, lstm_kernel_order(hidden, encoder))


@pytest.mark.parametrize("hidden", [128, 36])
def test_3xtf32_plain_k8_dense_within_serving_tolerance(monkeypatch, hidden):
    rng = np.random.default_rng(8)
    n, T, encoder = 256, 3, (64,)
    env = _serving_env()
    state = env.init_batch(2, n)
    model = _acting_policy(LSTMActorCritic(
        hidden, encoder, generator=torch.Generator().manual_seed(0)))
    carry = tuple(torch.from_numpy(
        0.5 * rng.standard_normal((n, hidden)).astype(np.float32))
        for _ in range(2))
    args = (state, model.flat, (hidden, encoder), carry, env.params,
            env.statics, T)
    wf, wc, ws = cuda_acting_lstm.lstm_act_rollout_plain(*args)
    _emulate_gates(monkeypatch)
    gf, gc, gs = cuda_acting_lstm.lstm_act_rollout_plain(*args)
    assert not torch.equal(gc[1], wc[1])
    _within_serving_tolerance((gf.fstate(), *gc, gs), (wf.fstate(), *wc, ws))
    assert float(gs[1].sum()) == float(ws[1].sum()) >= n


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
    then h and c over the gate block's units (hidden padded to 8), the
    heads' m and v and keep at the tile's row stride, one block; the gate
    weights' packed fragments."""
    A, L = cuda_acting_cnn, cuda_acting_lstm
    assert A.TOWER_FWD_SMEM == 4 * (A.W0_FRAG_FLOATS + 72 * 268) == 109952
    assert 2 * (A.TOWER_FWD_SMEM + 256 + 1024) <= SM_SMEM
    hp = L.gate_units(hidden)
    assert hp % 8 == 0 and hidden <= hp < hidden + 8
    smem = L.act_smem_bytes(hidden, KERNEL_ARCH)
    assert smem == A.TOWER_FWD_SMEM + 4 * 72 * (2 * hp + 6) <= MAX_SMEM - 256
    assert L.gate_packed_floats(hidden, KERNEL_ARCH) == 2 * (128 + hp) * 4 * hp
    if hidden == 128:
        assert smem == 185408
        assert L.gate_packed_floats(128, KERNEL_ARCH) == 2**18
    L.check_act_envelope(hidden, KERNEL_ARCH)


@pytest.mark.parametrize("hidden,encoder", [
    (128, (64,)), (36, (64,)), (8, ()), (16, (36, 20, 12)), (100, (13,))])
def test_dense_arm_shared_memory_and_fragments(hidden, encoder):
    """The dense arms' byte counts on the tensor-core tiles (rows of 64
    lanes at 72 floats): K8/K6's obs, encoder buffers, x (E padded to 8:
    13 with no encoder, widths like 36), h and c (hidden padded to 8); K7's
    walk, the larger of its forward (obs and buffers at 64 floats a row, x
    and h at 72) and its backward (dz, dx, [dm; g_v], keep at 72); the
    forward and transposed gate fragments."""
    L, U = cuda_acting_lstm, cuda_update_lstm
    hp, E = L.gate_units(hidden), (encoder or (13,))[-1]
    ep = L.gate_inputs(E)
    assert ep % 8 == 0 and E <= ep < E + 8
    mid = encoder[:-1]
    bufs = min(len(mid), 2) * max(mid, default=0)
    assert L.act_smem_bytes(hidden, encoder) == 4 * 72 * (
        13 + bufs + ep + 2 * hp + 6) <= MAX_SMEM - 256
    walk = U.bptt_smem_bytes(hidden, encoder)
    assert walk == max(4 * 64 * (13 + bufs) + 4 * 72 * (ep + hp),
                       4 * 72 * (4 * hp + max(ep, max(encoder, default=0))
                                 + 6)) <= MAX_SMEM
    assert L.gate_packed_floats(hidden, encoder) == 2 * (ep + hp) * 4 * hp
    assert U.gate_t_packed_floats(hidden, encoder) == 2 * 4 * hp * (ep + hp)
    if (hidden, encoder) == (128, (64,)):
        assert L.act_smem_bytes(hidden, encoder) == 97632
        assert walk == 167616
        assert L.gate_packed_floats(hidden, encoder) == 786432 // 4
    U.check_envelope(hidden, encoder)


def _fp32_design_accepts(hidden, encoder):
    """Whether the fp32 gate blocks' kernels took an LSTM: K8/K6's tiles of
    128 lanes at 128 floats a row, K7's walk of 64 lanes at 64 (with dh, dc
    and dz in shared memory), widths up to 4 x hidden."""
    mid = encoder[:-1]
    bufs = min(len(mid), 2) * max(mid, default=0)
    E = (encoder or (13,))[-1]
    act = 4 * 128 * (13 + bufs + E + 2 * hidden)
    walk = 4 * 64 * max(13 + bufs + E + 2 * hidden,
                        6 * hidden + max(encoder, default=0) + 6)
    return (act <= MAX_SMEM - 256 and walk <= MAX_SMEM
            and max(encoder, default=0) <= 4 * hidden)


def test_dense_arm_envelope_keeps_every_shape_of_the_fp32_kernels():
    """Every dense LSTM the fp32 kernels took still fits: seeded widths of
    0-4 layers up to 4 x hidden for every hidden 4-128 (a multiple of 4),
    and the shapes at the old limit where the tensor-core tiles' wider rows
    cost the most."""
    rng = np.random.default_rng(9)
    shapes = [(96, (275, 321)), (116, (174, 174, 201)), (108, (214,) * 3),
              (128, (256,)), (128, (512,)), (4, ()), (128, ())]
    for hidden in range(4, 129, 4):
        for n_enc in range(5):
            for _ in range(6):
                shapes.append((hidden, tuple(
                    int(w) for w in rng.integers(1, 4 * hidden + 1, n_enc))))
    took = 0
    for hidden, encoder in shapes:
        if not _fp32_design_accepts(hidden, encoder):
            continue
        took += 1
        cuda_update_lstm.check_envelope(hidden, encoder)
        assert max(cuda_update_lstm.kernel_smem_bytes(hidden, encoder)
                   + [cuda_acting_lstm.act_smem_bytes(hidden, encoder)]
                   ) <= MAX_SMEM
    assert took > 400


@pytest.mark.parametrize("hidden", [128, 64, 16])
def test_tower_kernels_shared_memory_and_scratch(hidden):
    """The byte counts the K7 wrapper passes (the walk, the tower's forward
    and backward, the products) and K10's: within a block's limit, the
    forward two blocks an SM; the CNN arm's walk holds x and h, then dz,
    dx, [dm; g_v] and keep, at the tensor-core stride (c, dh and dc in
    registers)."""
    U, C = cuda_update_lstm, cuda_update_cnn
    walk, fwd, bwd, prod = U.kernel_smem_bytes(hidden, KERNEL_ARCH)
    assert fwd == C.TOWER_FWD_SMEM == 109952 == 4 * (
        8192 + 72 * (12 + 2 * 64 + 2 * 64))
    assert bwd == C.TOWER_BWD_SMEM == 4 * 72 * (12 + 128 + 2 * 256 + 64)
    assert prod == U.PRODUCT_SMEM == 4 * 2 * 2 * 64 * 68 == 69632
    assert max(walk, fwd, bwd, prod) <= MAX_SMEM
    assert 2 * (fwd + 1024) <= SM_SMEM
    hp = cuda_acting_lstm.gate_units(hidden)
    assert walk == U.bptt_smem_bytes(hidden, KERNEL_ARCH) == 4 * 72 * max(
        128 + hp, 4 * hp + 128 + 6)
    assert U.kernel_smem_bytes(hidden, (64,))[1:] == [0, 0, 69632]
    U.check_envelope(hidden, KERNEL_ARCH)
    rows = U.scratch_rows(hidden, KERNEL_ARCH)
    assert rows[U.XS] == 13 + 128 + hidden and rows[U.DP] == 128
    assert rows[U.X2S] == 576
    # K10's scratch per chunk: X2 and dzt of at most MAX_SCRATCH samples
    tch = C.pick_chunk_steps(128, 16384)
    assert tch * 16384 <= C.MAX_SCRATCH and (tch * 16384) % C.TILE == 0
    assert C.FP_W == 645 + 8 and C.BP_W == 20608
    assert C.PACKED_FLOATS == 4 * (64 * 64 + 2 * 256 * 64 + 2 * 576 * 128) // 2


@pytest.mark.parametrize("hidden", [(64, 64), (32, 32)])
def test_3xtf32_plain_k3_within_tolerance(monkeypatch, hidden):
    rng = np.random.default_rng(10)
    T, n = 2, 256
    planes, advret = _planes(rng, T, n)
    model = _acting_policy(ActorCritic(
        hidden, generator=torch.Generator().manual_seed(0)))
    co = UpdateConsts(0.2, 0.5, 0.5, 1.0 / (128 * T))
    args = (planes, advret, torch.tensor([1], dtype=torch.int32), model.flat,
            hidden, co, 128, 0.001)
    want = cuda_update.ppo_update_plain(*args)
    monkeypatch.setattr(cuda_update, "tower_mm", cuda_update_cnn.mm_3xtf32)
    got = cuda_update.ppo_update_plain(*args)
    assert not torch.equal(got[0], want[0])  # the emulation ran
    _within_update_tolerance(got, want, kernel_order(hidden))


@pytest.mark.parametrize("stochastic", [False, True])
def test_3xtf32_plain_k5_within_serving_tolerance(monkeypatch, stochastic):
    n, T = 384, 3
    env = _serving_env()
    state = env.init_batch(2, n)
    model = _acting_policy(
        ActorCritic((64, 64), generator=torch.Generator().manual_seed(0)))
    args = (state, model, env.params, env.statics, T, stochastic)
    wf, ws = cuda_acting.act_rollout_plain(*args)
    mm = cuda_update_cnn.mm_3xtf32
    monkeypatch.setattr(ActorCritic, "_dense",
                        lambda self, lin, x: mm(x, lin.weight.t()) + lin.bias)
    gf, gs = cuda_acting.act_rollout_plain(*args)
    assert not torch.equal(gf.fstate(), wf.fstate())  # the emulation ran
    _within_serving_tolerance((gf.fstate(), gs), (wf.fstate(), ws))
    assert float(gs[1].sum()) == float(ws[1].sum()) >= n


def _swz(r):
    """csrc/update.cu's column swizzle of row r."""
    return ((r & 3) << 3) | (r & 4)


def _distinct_banks(words):
    """32 lanes' word addresses hit 32 different banks."""
    return len({int(w) % 32 for w in np.ravel(words)}) == 32


@pytest.mark.parametrize("hidden", [(64, 64), (32, 48, 20), (), (13,)])
def test_k3_weight_planes_sums_and_activations(hidden):
    """csrc/update.cu's layout, mirrored: pack_planes_kernel's planes read
    back by the forward's and the input gradient's fragment indices give
    W^T and W (zero-padded), with every fragment read of the planes and of
    the swizzled activation rows free of bank conflicts; each flat gradient
    has its own running-sum entry (W's row, then the bias column), whose
    fragment float2 folds are free of bank conflicts; the shared memory
    byte counts the wrapper passes."""
    lay = cuda_update.mma_layout(hidden)
    model = ActorCritic(hidden, generator=torch.Generator().manual_seed(3))
    flat = model.flatten_().numpy()
    offs, total = kernel_offsets(hidden)
    names = [[f"{tw}_h{i}" for i in range(len(hidden))] + [head]
             for tw, head in (("actor", "actor_mean"),
                              ("critic", "critic_value"))]
    planes = np.full(lay["wf"], np.nan, np.float32)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    sums_of = {}
    for tower, layers in enumerate(lay["layers"]):
        for li, y in enumerate(layers):
            nin, nout, sw, wp = y["nin"], y["nout"], y["sw"], y["wp"]
            w0 = offs[f"{names[tower][li]}.weight"]
            W = flat[w0:w0 + nout * nin].reshape(nout, nin)
            # pack_planes_kernel
            e = np.arange(-(-nout // 8) * 8 * sw)
            o, c = e // sw, e % sw
            i = c ^ _swz(o) if y["swizzled"] else c
            ok = (o < nout) & (i < nin)
            vals = np.zeros(e.size, np.float32)
            vals[ok] = W[o[ok], i[ok]]
            planes[wp + e] = vals
            K, N = -(-nin // 8) * 8, -(-nout // 8) * 8
            Wp = np.zeros((N, K), np.float32)
            Wp[:nout, :nin] = W

            def wi(oo, ii):
                return wp + oo * sw + (ii ^ _swz(oo) if y["swizzled"] else ii)

            k, n = np.arange(K)[:, None], np.arange(N)[None, :]
            np.testing.assert_array_equal(planes[wi(n, k)], Wp.T)
            for k0 in range(0, K, 8):
                for n0 in range(0, N, 8):
                    for h in (0, 4):
                        assert _distinct_banks(wi(n0 + g, k0 + t + h))
            if li > 0:  # the input gradient reads W
                np.testing.assert_array_equal(planes[wi(n.T, k.T)], Wp)
                for k0 in range(0, N, 8):
                    for n0 in range(0, K, 8):
                        for h in (0, 4):
                            assert _distinct_banks(wi(k0 + t + h, n0 + g))
            # the running sums and the kernel's copy to the flat row
            assert y["ss"] >= nin + 1 and y["ss"] % 16 == 8
            for r in range(nout * (nin + 1)):
                sums_of[w0 + r] = y["sb"] + (
                    (r // nin) * y["ss"] + r % nin if r < nout * nin
                    else (r - nout * nin) * y["ss"] + nin)
            for half in (0, 1):  # a fold's float2 words, half a warp
                gg, tt = g[16 * half:16 * half + 16], t[16 * half:16 * half + 16]
                pairs = (y["sb"] + gg * y["ss"] + 2 * tt) // 2
                assert len({int(p) % 16 for p in pairs}) == 16
    assert not np.isnan(planes).any()
    assert sorted(sums_of) == [e for e in range(total)
                               if not offs["log_std"] <= e < offs["log_std"] + 4]
    assert len(set(sums_of.values())) == len(sums_of)
    assert max(sums_of.values()) < lay["sf"]
    # the activations: rows of 64 samples, swizzled
    def ai(r, s):
        return r * 64 + (s ^ _swz(r))
    for r0 in range(16):
        for m0 in (0, 16, 32, 48):
            assert _distinct_banks(ai(r0 + t, m0 + g))         # A, M = samples
            assert _distinct_banks(ai(r0 + g, 8 * (m0 // 16) + t))  # M = rows
    rows = 13 + 2 * sum(hidden) + 5 + 16
    assert lay["rows"] == rows and lay["hm"] == 13 + 2 * sum(hidden)
    static = cuda_update.STAT_PART_BYTES
    if lay["onchip"]:
        assert lay["smem"] == 4 * (64 * rows + 2 * lay["wf"] + lay["sf"])
    assert lay["smem"] + static <= MAX_SMEM
    if hidden == (64, 64):
        assert lay["onchip"] and lay["smem"] == 219040
        assert (lay["wf"], lay["sf"]) == (11776, 12648)


def _fp32_k3_took(hidden):
    """The fp32 K3's envelope: at most 8 hidden layers, the tile's rows
    (obs, both towers, 5 head and 8 stat rows) at 65 floats a row."""
    return (len(hidden) <= 8
            and 4 * 65 * (13 + 2 * sum(hidden) + 13) <= MAX_SMEM)


def _fp32_k5_took(widths):
    """The fp32 K5's envelope: at most 8 hidden layers of width <= 256, the
    weights (W^T, outputs padded to 16, and biases) and a 128-lane block's
    activation columns in a block's shared memory."""
    if len(widths) > 8 or any(w > 256 for w in widths):
        return False
    nin, n_w = 13, 0
    for w in widths:
        n_w += (nin + 1) * (-(-w // 16) * 16)
        nin = w
    n_w = -(-(n_w + (nin + 1) * 4) // 4) * 4
    n_buf = 2 if len(widths) >= 3 else (1 if len(widths) == 2 else 0)
    maxw = max((-(-w // 16) * 16 for w in widths), default=0)
    return 4 * (n_w + (16 + n_buf * maxw) * 128) <= MAX_SMEM - 256


def test_mlp_envelopes_keep_every_tower_of_the_fp32_kernels():
    """Every tower the fp32 K3 and K5 took is still taken, and every tower
    they refused is still refused (so train.build and evaluate route as
    before): seeded towers of 0-9 hidden layers around both limits, and the
    towers at them."""
    rng = np.random.default_rng(12)
    shapes = [(), (434,), (435,), (217, 217), (217, 218), (256, 256),
              (256, 64), (256, 72), (8,) * 8, (8,) * 9, (64, 64),
              (32, 48, 20), (20, 40, 8, 24), (300,), (1,) * 8]
    for depth in range(1, 10):
        for _ in range(16):
            total = int(rng.integers(depth, 520))
            cuts = np.sort(rng.choice(np.arange(1, total), depth - 1,
                                      replace=False)) if depth > 1 else []
            shapes.append(tuple(int(w) for w in
                                np.diff([0, *cuts, total])))
    took3 = took5 = 0
    for hidden in shapes:
        try:
            cuda_update.update_layout(hidden)
            k3 = True
        except ValueError:
            k3 = False
        assert k3 == _fp32_k3_took(hidden), hidden
        if k3:
            took3 += 1
            lay = cuda_update.mma_layout(hidden)
            assert lay["smem"] + cuda_update.STAT_PART_BYTES <= MAX_SMEM
        try:
            cuda_acting.check_envelope(hidden)
            k5 = True
        except ValueError:
            k5 = False
        assert k5 == _fp32_k5_took(hidden), hidden
        if k5:
            took5 += 1
            lay = cuda_acting.act_layout(hidden)
            assert 32 <= lay["bl"] <= 512 and lay["smem"] <= MAX_SMEM - 256
    assert took3 > 60 and took5 > 40


def test_k5_residency_and_activation_reads():
    """K5 at [64, 64]: 512 lanes a block (rows of 520 floats: a fragment's
    reads in 32 banks), the weights' 45,600 bytes and 80 activation rows,
    one block an SM: 65,536 lanes in 128 blocks, one wave on 132 SMs."""
    lay = cuda_acting.act_layout((64, 64))
    assert lay["wsm"] and lay["bl"] == 512 and lay["rows"] == 16 + 64
    assert lay["wfl"] == 2 * (16 * 64 + 64 * 64 + 64 * 8) + 64 + 64 + 8
    assert lay["smem"] == 4 * (lay["wfl"] + 80 * 520) == 212000
    assert 2 * (lay["smem"] + 256 + 1024) > SM_SMEM  # one block an SM
    assert -(-65536 // lay["bl"]) == 128 <= 132
    g, t = np.arange(32) // 4, np.arange(32) % 4
    for i in (0, 16):
        for h in (0, 4):
            assert _distinct_banks((t + h) * 520 + i + g)
