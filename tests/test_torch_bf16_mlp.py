"""The bf16 tensor-core design of the bfloat16 arms of K3 (csrc/update.cu
update_kernel<ONCHIP, true>, pack_b16_kernel; ops/cuda_update.py
b16_layout) and K2 (csrc/acting_traj.cu traj_kernel<..., true>,
pack_traj_b16_kernel, csrc/tower_mma.cuh's _b16 forms;
ops/cuda_acting_traj.py layout_at(..., bf16=True)), on the CPU.

The kernel multiplies with mma.sync m16n8k16 bf16 (both operands rounded to
bfloat16, each product exact, 16 products summed in a group before the
group joins the float32 accumulator); `cuda_update_cnn.mm_bf16_k16` is that
product in torch, and here it takes the place of the plain version's tower
products (`cuda_update.tower_mm`, K2's `cuda_acting_traj.tower_forward`),
which must still meet H12's CPU rule
against drone_tpu's bf16 reference (tests/test_torch_bf16.py: at least 99%
of the values within rtol 2e-5 / atol 2e-6, each gradient tensor within
1e-3 of its largest |value|, the mean difference under a tenth of the one
to the fp32 reference), unwidened. db stays the float32 sum of dY.

The layouts the kernels compute with are mirrored in Python: K3's packed
A fragments (bf16x2 pairs of W and of W^T, m16n8k16's a0..a3), K2's packed
B fragments (W^T, m16n8k16's b0, b1), and the shared memory, scratch and
packed words the wrappers pass (K3 on chip at [64, 64] and off chip at
[128, 128]), for every tower the fp32 arms take.
"""
import numpy as np
import pytest
import torch

from drone_tpu_torch.models import kernel_offsets, kernel_order
from drone_tpu_torch.ops import cuda_acting_traj, cuda_update, cuda_update_cnn
from drone_tpu_torch.ops.cuda_acting_traj import operand
from tests import test_torch_bf16 as tb

BF16 = "bfloat16"
MAX_SMEM = 232448        # bytes a block of an H100 can take
B16_S = 72               # a bf16 activation row (csrc/update.cu B16_S)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _up(x, m):
    return -(-x // m) * m


def bf16_bits(x) -> np.ndarray:
    """float32 -> bf16 bits, nearest even (cvt.rn.bf16x2.f32)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def pack_b16(theta, hidden) -> np.ndarray:
    """pack_b16_kernel mirrored: (wq, 4) uint32 words. uint4 e is lane e %
    32 of a 16 x 16 tile of A = W (the forward) or W^T (the input gradient,
    layers past the first), the bf16x2 pairs (A[m][k], A[m][k + 1]) of (m,
    k) = (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8), the lower k in
    the lower half; a layer's tiles row-major at b16_layout's fa and ta."""
    lay = cuda_update.b16_layout(hidden)
    offs, _ = kernel_offsets(hidden)
    names = [(f"actor_h{i}", f"critic_h{i}") for i in range(len(hidden))]
    names.append(("actor_mean", "critic_value"))
    out = np.zeros((lay["wq"], 4), np.uint32)
    for t in (0, 1):
        for li, y in enumerate(lay["layers"][t]):
            o = offs[f"{names[li][t]}.weight"]
            W = theta[o:o + y["nout"] * y["nin"]].reshape(y["nout"], y["nin"])
            for tr, base in ((0, y["fa"]), (1, y["ta"]))[:1 + (li > 0)]:
                A = W.T if tr else W
                M, K = _up(A.shape[0], 16), _up(A.shape[1], 16)
                Ap = np.zeros((M, K), np.float32)
                Ap[:A.shape[0], :A.shape[1]] = A
                bits = bf16_bits(Ap).astype(np.uint32)
                kts = K // 16
                for q in range(M // 16 * kts):
                    for lane in range(32):
                        g, tt = lane // 4, lane % 4
                        m, k = 16 * (q // kts) + g, 16 * (q % kts) + 2 * tt
                        out[base + 32 * q + lane] = [
                            bits[mm, kk] | bits[mm, kk + 1] << 16
                            for mm, kk in ((m, k), (m + 8, k), (m, k + 8),
                                           (m + 8, k + 8))]
    return out


@pytest.mark.parametrize("hidden", [(64, 64), (128, 128), (48, 24)])
def test_bf16_fragments_hold_w_and_its_transpose(hidden):
    """The packed A fragments, read back by m16n8k16's register layout,
    give every layer's W (the forward) and W^T (the input gradient) rounded
    to bf16, zero past its widths, each weight once in each; the tiles of
    the layers and towers follow each other with no gap."""
    offs, P = kernel_offsets(hidden)
    theta = np.random.default_rng(len(hidden)).normal(size=P).astype(
        np.float32)
    words = pack_b16(theta, hidden)
    lay = cuda_update.b16_layout(hidden)
    seen = 0
    for t in (0, 1):
        for li, y in enumerate(lay["layers"][t]):
            name = (f"{('actor', 'critic')[t]}_h{li}" if li < len(hidden)
                    else ("actor_mean", "critic_value")[t])
            o = offs[f"{name}.weight"]
            W = theta[o:o + y["nout"] * y["nin"]].reshape(y["nout"], y["nin"])
            assert y["fa"] == seen
            for tr, base in ((0, y["fa"]), (1, y["ta"]))[:1 + (li > 0)]:
                A = W.T if tr else W
                M, K = _up(A.shape[0], 16), _up(A.shape[1], 16)
                got = np.zeros((M, K), np.uint16)
                for q in range(M // 16 * (K // 16)):
                    for lane in range(32):
                        g, tt = lane // 4, lane % 4
                        m = 16 * (q // (K // 16)) + g
                        k = 16 * (q % (K // 16)) + 2 * tt
                        for r, (mm, kk) in enumerate(((m, k), (m + 8, k),
                                                      (m, k + 8),
                                                      (m + 8, k + 8))):
                            w = int(words[base + 32 * q + lane, r])
                            got[mm, kk], got[mm, kk + 1] = w & 0xFFFF, w >> 16
                want = np.zeros((M, K), np.uint16)
                want[:A.shape[0], :A.shape[1]] = bf16_bits(A)
                np.testing.assert_array_equal(got, want)
                seen += M * K // 8
            assert seen == (lay["layers"][t][li + 1]["fa"]
                            if li < len(hidden) else
                            (lay["layers"][1][0]["fa"] if t == 0
                             else lay["wq"]))


def _b16_bytes(hidden):
    """update.cu's layout_smem_b16 from its parts: bf16 rows of 72 (the
    obs, each tower's hidden layers padded to 16, the heads' dY 16 each)
    and the heads' 8 fp32 rows of 64 floats; on chip also the fp32 tanh
    rows, the fragments (16 bytes a lane a 16 x 16 tile of W and of W^T)
    and the running sums (sums_stride floats a row)."""
    L = len(hidden)
    rows = 16 + 2 * sum(_up(w, 16) for w in hidden) + 2 * 16
    tiles, sums = 0, 0
    for t in (0, 1):
        nin = 13
        for li in range(L + 1):
            nout = hidden[li] if li < L else (4, 1)[t]
            tiles += _up(nout, 16) * _up(nin, 16) // 256 * (1 + (li > 0))
            sums += nout * cuda_update.sums_stride(nin)
            nin = nout
    base = 2 * rows * B16_S + 4 * 8 * 64
    return base, base + 4 * 2 * sum(hidden) * 64 + 16 * 32 * tiles + 4 * sums


@pytest.mark.parametrize("hidden, onchip", [((64, 64), True),
                                            ((128, 128), False),
                                            ((48, 24), True),
                                            ((), True), ((434,), False),
                                            ((32, 48, 20), True)])
def test_bf16_layout_bytes(hidden, onchip):
    """b16_layout's shared memory and scratch against their parts: hover's
    [64, 64] keeps the tanh rows, the fragments and the running sums on
    chip (207,008 bytes beside 1,156 static), [128, 128] and the widest
    tower off chip (a block's scratch row: the sums, then the tanh rows)."""
    lay = cuda_update.b16_layout(hidden)
    off, on = _b16_bytes(hidden)
    assert lay["onchip"] == onchip == (on + cuda_update.B16_STATIC_BYTES
                                       <= MAX_SMEM)
    assert lay["smem"] == (on if onchip else off)
    assert lay["smem"] + cuda_update.B16_STATIC_BYTES <= MAX_SMEM
    assert lay["scratch"] == (0 if onchip else
                              lay["sf"] + 2 * sum(hidden) * 64)
    if hidden == (64, 64):
        assert lay["smem"] == 207008 and cuda_update.B16_STATIC_BYTES == 1156
    assert cuda_update.B16_STATIC_BYTES == 4 * (5 + 2 * 9 * 10) + 8 * 13 * 4


def test_bf16_envelope_takes_every_fp32_shape():
    """Every tower the fp32 kernel takes (update_layout's envelope: at most
    8 hidden layers, widths summing to 434) fits the bf16 arm, on chip or
    off it, so train.build's routing is the same under bfloat16."""
    for hidden in [(434,), (217, 217), (100, 100, 100, 134), (8,) * 8,
                   (64, 64), (1,), (431, 3)]:
        cuda_update.update_layout(hidden)  # the envelope takes it
        lay = cuda_update.b16_layout(hidden)
        assert lay["smem"] + cuda_update.B16_STATIC_BYTES <= MAX_SMEM
    with pytest.raises(ValueError):
        cuda_update.update_layout((435,))


@pytest.fixture
def k16(monkeypatch):
    """The plain K3's tower products as m16n8k16 bf16."""
    monkeypatch.setattr(cuda_update, "tower_mm", cuda_update_cnn.mm_bf16_k16)


@pytest.mark.parametrize("off_policy", [False, True])
def test_k16_plain_k3_matches_reference(k16, off_policy):
    """The plain bf16 K3 with its products as m16n8k16 against the
    reference's bf16 update, on and off the planes' weights, by H12's rule
    unwidened."""
    tb.test_plain_bf16_update_matches_reference(off_policy)


def test_k16_plain_k3_db_is_the_fp32_sum_of_dy(k16):
    """db of every layer is the float32 sum of that layer's dY (as the
    reference's jnp.sum), not of its bf16 rounding: the kernel sums the
    fp32 values on the CUDA cores and rounds only the products' operands."""
    _, model, out = tb._mlp_reference(True)
    planes = tb._traj_planes(out[BF16][1])
    advret = tb._advret(planes)
    T, _, N = planes.shape
    co = cuda_update.UpdateConsts(0.2, 0.5, 0.5, 1.0 / (N // 2 * T))
    pl, ar = torch.from_numpy(planes), torch.from_numpy(advret)
    perm = torch.tensor([3, 0], dtype=torch.int32)
    grads, _ = cuda_update.ppo_update_plain(pl, ar, perm, model.flat,
                                            model.hidden, co, 128,
                                            compute_dtype=BF16)
    # dY of each layer, from the plain version's own pieces
    actor, critic, ls = cuda_update.tower_weights(model.flat, model.hidden)
    X, a, logp_old, v_old, adv, ret = cuda_update.gather_minibatch(
        pl, ar, perm, 128)
    with torch.no_grad():
        m, acts_a = cuda_update._tower_fwd(X, actor, BF16)
        v, acts_c = cuda_update._tower_fwd(X, critic, BF16)
        dm, g_v, _ = cuda_update.head_grads(m, v[:, 0], a, logp_old, v_old,
                                            adv, ret, ls, co)
        offs, _ = kernel_offsets(model.hidden)
        checked = 0
        for tower, weights, acts, dy, head in (
                ("actor", actor, acts_a, dm, "actor_mean"),
                ("critic", critic, acts_c, g_v[:, None], "critic_value")):
            for li in range(len(weights) - 1, -1, -1):
                name = head if li == len(weights) - 1 else f"{tower}_h{li}"
                o = offs[f"{name}.bias"]
                db = grads[o:o + dy.shape[1]].double()
                exact = dy.double().sum(0)
                rounded = operand(dy, BF16).double().sum(0)
                scale = dy.double().abs().sum(0) + 1e-30
                assert ((db - exact).abs() / scale).max() < 1e-6, name
                # the bf16 rounding of dY moves the sum by ~2^-9 of its terms
                assert ((rounded - exact).abs() / scale).max() > 1e-5, name
                checked += 1
                if li:
                    y = acts[li]
                    dy = cuda_update.tower_mm(
                        operand(dy, BF16), operand(weights[li][0], BF16)) \
                        * (1.0 - y * y)
    assert checked == 2 * (len(model.hidden) + 1)


def test_k3_wrapper_passes_the_bf16_layout(monkeypatch):
    """ppo_update_kernel passes the bf16 arm's byte counts, fragment words
    and scratch row (b16_layout) and up to 132 blocks, the fp32 arm's
    mma_layout and 128, to the C entry, which refuses any other (here the
    C entry is a stand-in that records its arguments)."""
    calls = []

    class Fn:
        argtypes = restype = None

        def __call__(self, *args):
            dims = np.ctypeslib.as_array(
                (np.ctypeslib.ctypes.c_int * 4).from_address(args[11]))
            calls.append((dims.copy(), args[16], args[17]))
            return 0

    class Lib:
        drone_ppo_update = Fn()

    class Dev:
        type = "cuda"

    monkeypatch.setattr(cuda_update.cuda_build, "load", lambda name: Lib())
    monkeypatch.setattr(cuda_update, "check_cuda_tensor", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: type("S", (), {"cuda_stream": 0}))
    hidden = (64, 64)
    _, P = kernel_offsets(hidden)
    T, n, rbl = 64, 65536, 1024
    planes = torch.empty(T, 21, n)
    advret = torch.empty(2, T, n)
    perm = torch.zeros(8, dtype=torch.int32)
    theta = torch.zeros(P)
    co = cuda_update.UpdateConsts(0.2, 0.2, 0.5, 1.0 / (8 * rbl * T))
    for dtype in ("float32", BF16):
        cuda_update.ppo_update_kernel(planes, advret, perm, theta, hidden, co,
                                      rbl, compute_dtype=dtype)
    (d32, g32, f32), (d16, g16, f16) = calls
    m, b = cuda_update.mma_layout(hidden), cuda_update.b16_layout(hidden)
    assert list(d32) == [m["smem"], 1, m["wf"], m["sf"]] and (g32, f32) == (
        128, 0)
    assert list(d16) == [b["smem"], 1, b["wq"], 0] and (g16, f16) == (132, 1)
    assert kernel_order(hidden)  # the layout's tensors


def pack_traj_b16(theta, hidden) -> np.ndarray:
    """pack_traj_b16_kernel mirrored: (4 f4, 2) uint32 words, the actor's
    fragments then the critic's. uint2 (kt NT + nt) 32 + lane of a layer
    (from its fo) holds B = W^T's bf16x2 pairs (B[k][n], B[k + 1][n]) and
    (B[k + 8][n], B[k + 9][n]), k = 16 kt + 2t, n = 8 nt + g (m16n8k16's
    b0, b1), zero past the widths; the heads one n-tile of 8 columns, the
    critic's value in column 4."""
    lay = cuda_acting_traj.layout_at(hidden, 512, 0, bf16=True)
    offs, _ = kernel_offsets(hidden)
    out = np.zeros((4 * lay["f4"], 2), np.uint32)
    for tw, (tower, head) in enumerate((("actor", "actor_mean"),
                                        ("critic", "critic_value"))):
        for li, y in enumerate(lay["layers"]):
            name = f"{tower}_h{li}" if li < len(hidden) else head
            nout = y["nout"] if li < len(hidden) else (4, 1)[tw]
            o = offs[f"{name}.weight"]
            W = theta[o:o + nout * y["nin"]].reshape(nout, y["nin"])
            B = np.zeros((_up(y["nin"], 16), y["nout"]), np.float32)
            col = 4 if li == len(hidden) and tw else 0
            B[:y["nin"], col:col + nout] = W.T
            bits = bf16_bits(B).astype(np.uint32)
            NT = y["nout"] // 8 if li == len(hidden) else _up(y["nout"], 8) // 8
            B = np.pad(bits, ((0, 0), (0, 8 * NT - bits.shape[1])))
            for kt in range(B.shape[0] // 16):
                for nt in range(NT):
                    for lane in range(32):
                        g, t = lane // 4, lane % 4
                        k, n = 16 * kt + 2 * t, 8 * nt + g
                        out[2 * lay["f4"] * tw + y["fo"] + 32 * (kt * NT + nt)
                            + lane] = [B[k, n] | B[k + 1, n] << 16,
                                       B[k + 8, n] | B[k + 9, n] << 16]
    return out


@pytest.mark.parametrize("hidden", [(64, 64), (128, 128), (32, 48, 20),
                                    ()])
def test_k2_bf16_fragments_hold_w_transposed(hidden):
    """K2's packed B fragments, read back by m16n8k16's register layout,
    give every layer's W^T rounded to bf16 (the heads' 8 columns: the 4
    means, then the value in column 4), zero past its widths, each weight
    once; the layers and towers follow each other with no gap; the packed
    buffer's floats are the fragments', then the biases'."""
    offs, P = kernel_offsets(hidden)
    theta = np.random.default_rng(7).normal(size=P).astype(np.float32)
    words = pack_traj_b16(theta, hidden)
    lay = cuda_acting_traj.layout_at(hidden, 512, 0, bf16=True)
    seen = np.zeros(P, np.int64)
    for tw in (0, 1):
        fo = 0
        for li, y in enumerate(lay["layers"]):
            assert y["fo"] == fo
            NT, KT = _up(y["nout"], 8) // 8, _up(y["nin"], 16) // 16
            for q in range(KT * NT):
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    k = 16 * (q // NT) + 2 * t
                    n = 8 * (q % NT) + g
                    for r, kk in enumerate((k, k + 8)):
                        w = int(words[2 * lay["f4"] * tw + fo + 32 * q + lane,
                                      r])
                        for kj, half in ((kk, w & 0xFFFF), (kk + 1, w >> 16)):
                            head = li == len(hidden)
                            o = n - (4 if head and tw else 0)
                            nout = (4, 1)[tw] if head else y["nout"]
                            if 0 <= o < nout and kj < y["nin"]:
                                name = (("actor_mean", "critic_value")[tw]
                                        if head else
                                        f"{('actor', 'critic')[tw]}_h{li}")
                                e = offs[f"{name}.weight"] + o * y["nin"] + kj
                                assert half == bf16_bits(theta[e]), (li, o, kj)
                                seen[e] += 1
                            else:
                                assert half == 0
            fo += KT * NT * 32
        assert fo == 2 * lay["f4"]
    weights = [offs[f"{t}_h{i}.weight"] for t in ("actor", "critic")
               for i in range(len(hidden))]
    assert all(seen[w] == 1 for w in weights)
    assert lay["wfl"] == _up(8 * lay["f4"] + 2 * lay["nb"], 4)


@pytest.mark.parametrize("hidden", [(64, 64), (128, 128), (32, 48, 20), (),
                                    (48,), (24, 40)])
def test_k2_bf16_layout_bytes(hidden):
    """K2's bf16 layout against its parts: the fragments a quarter of
    3xTF32's bytes per k-tile of 16 (a uint2 a lane a 16 x 8 tile), the
    warp's rows bf16 with each stored layer padded to 16; the most lanes a
    block (512) with the fragments staged in shared memory at every main
    path's shape, and at least as many lanes as the fp32 arm's."""
    f32 = cuda_acting_traj.traj_layout(hidden)
    b16 = cuda_acting_traj.traj_layout(hidden, BF16)
    L = len(hidden)
    fan = [13, *hidden, 8]
    frags = sum(_up(fan[i], 16) * _up(fan[i + 1], 8) // 4 for i in range(L + 1))
    assert b16["f4"] * 2 == frags
    stored = [_up(w, 16) for w in hidden[:-1]]
    mw = max(stored, default=0)
    rows = 16 + (mw if L >= 2 else 0) + (mw if L >= 3 else 0)
    assert b16["rows"] == rows
    assert b16["smem"] == 4 * (b16["hf"] + b16["wsm"] * 8 * b16["f4"]) + \
        2 * rows * (b16["bl"] + 8)
    assert b16["bl"] >= f32["bl"] and b16["smem"] <= 232448 - 256
    if hidden == (64, 64):
        assert (b16["bl"], b16["wsm"], b16["smem"]) == (512, 1, 106848)


@pytest.fixture
def k16_traj(monkeypatch):
    """The plain K2's tower products as m16n8k16 bf16 (each group of 16
    summed before it joins the float32 sum, as the kernel's IEEE adds)."""
    mm = cuda_update_cnn.mm_bf16_k16

    def tower_forward(x, weights, compute_dtype="float32"):
        for li, (w, b) in enumerate(weights):
            x = mm(x, w.t()) + b
            if li < len(weights) - 1:
                x = torch.tanh(x)
        return x

    monkeypatch.setattr(cuda_acting_traj, "tower_forward", tower_forward)


def test_k16_plain_k2_matches_reference(k16_traj):
    """The plain bf16 K2 with its tower products as m16n8k16 against the
    reference's bf16 rollout by H12's rule unwidened."""
    tb.test_plain_bf16_traj_matches_reference()
