"""The layouts of K7's bf16 walk through time and of its dense arm's bf16
weight products (csrc/update_lstm.cu bptt_walk_b16, grad_rounded_kernel,
pack_gates_b16_kernel, pack_gates_t_b16_kernel; csrc/lstm_mma.cuh
lstm_gates_b16, gates_bwd_b16), mirrored in numpy on the CPU, and the plain
bf16 K7 with the walk's products as the kernels run them.

The walk multiplies on the bf16 tensor cores (mma.sync m16n8k16) operands
stored once as bfloat16: the gate weights as bf16x2 pairs {B[k][n], B[k +
1][n]} (rounded to nearest even) in the order the fragment loaders read
them, x, h and dz as bf16 rows of the tile whose A fragments ldmatrix.trans
loads; K = Ep + Hp runs in k-tiles of 16, zero rows after h's. The dense
arm's products keep one TF32 product a k-step of bf16 values, bitwise the
first bf16 design's, from each window's operands rounded once into bf16x2
rows. Here each fragment a loader reads is held to the mma.sync fragment it
must be, each packed word read once, and the shared memory and scratch the
wrapper passes to the kernel's own counts.
"""
import numpy as np
import pytest
import torch

from drone_tpu_torch.models import lstm as lstm_model
from drone_tpu_torch.ops import cuda_update_cnn
from drone_tpu_torch.ops import cuda_update_lstm as U
from drone_tpu_torch.ops.cuda_acting_cnn import KERNEL_ARCH
from drone_tpu_torch.ops.cuda_acting_lstm import (
    gate_inputs,
    gate_packed_floats,
    gate_units,
)
from tests import test_torch_bf16_lstm as tbl
from tests import test_torch_bf16_mma as tm

BF16 = "bfloat16"
MAX_SMEM = 232448   # bytes a block of an H100 can take
TMB = 72            # bf16 a row of the walk's tiles (cnn_mma.cuh TMB)
GR_S = 36           # words a row of grad_rounded_kernel's tiles
GATE_WARPS = 8
RING = 4 * 32 * 32  # a warp's ring of fragments (lstm_mma.cuh)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bf16_bits(x) -> np.ndarray:
    """bf16 round-to-nearest-even of fp32 values, as uint16 bits."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def widened(bits) -> np.ndarray:
    """bf16 bits as the fp32 bits the TF32 instruction takes."""
    return np.asarray(bits, np.uint32) << 16


def gate_row(k, E, H):
    """WP's row of the gate block's input row k (x's Ep, then h's Hp), or
    -1 for a padded row (lstm_mma.cuh gate_row)."""
    ep = gate_inputs(E)
    k = np.asarray(k)
    return np.where(k < ep, np.where(k < E, k, -1),
                    np.where(k - ep < H, E + k - ep, -1))


def weight(wp, k, n, E, H):
    """B[k][n] of the gate block: column n = 32 ug + 8 gate + j is gate
    `gate` of unit 8 ug + j; zero for a padded unit or row."""
    row = gate_row(k, E, H)
    u = 8 * (n // 32) + n % 8
    gate = (n // 8) % 4
    ok = (u < H) & (row >= 0)
    return np.where(ok, wp[np.where(ok, row, 0), np.where(ok, u, 0), gate],
                    np.float32(0))


def k16(E, H):
    """The forward product's rows: Ep + Hp to a multiple of 16."""
    return -(-(gate_inputs(E) + gate_units(H)) // 16) * 16


def pair(wp, k, n, E, H):
    """{bf16(B[k][n]), bf16(B[k + 1][n])} as one word, k lower."""
    return (bf16_bits(weight(wp, k, n, E, H)).astype(np.uint32)
            | bf16_bits(weight(wp, k + 1, n, E, H)).astype(np.uint32) << 16)


def pack_gates_b16(wp, E, H) -> np.ndarray:
    """pack_gates_b16_kernel: word i of k16 x 4 Hp / 2, two uint4s a lane
    of each k-tile of 16 and unit group; word c is pair c % 2 of n-tile 4
    ug + c / 2."""
    UG = gate_units(H) // 8
    i = np.arange(k16(E, H) * gate_units(H) * 2)
    c, lane, ug, kt = i % 8, (i // 8) % 32, (i // 256) % UG, i // (256 * UG)
    k = 16 * kt + 2 * (lane % 4) + 8 * (c % 2)
    n = 8 * (4 * ug + c // 2) + lane // 4
    return pair(wp, k, n, E, H)


def pack_gates_t_b16(wp, E, H) -> np.ndarray:
    """pack_gates_t_b16_kernel: a uint2 a lane of each k-tile of 16 and
    n-tile over B^T (k a gate column, n an input row)."""
    NT = (gate_inputs(E) + gate_units(H)) // 8
    i = np.arange(gate_units(H) // 2 * NT * 32)
    c, lane, tile = i % 2, (i // 2) % 32, i // 64
    kt, nt = tile // NT, tile % NT
    k, n = 16 * kt + 2 * (lane % 4) + 8 * c, 8 * nt + lane // 4
    return (bf16_bits(weight(wp, n, k, E, H)).astype(np.uint32)
            | bf16_bits(weight(wp, n, k + 1, E, H)).astype(np.uint32) << 16)


def _wp(E, H, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(E + H, H, 4)).astype(np.float32)


SHAPES = [(64, 128), (128, 128), (13, 128), (13, 20)]


def _lo_hi(w):
    """A bf16x2 word's two values, as the fp32 bits they widen to."""
    return w << 16, w & 0xffff0000


@pytest.mark.parametrize("E,H", SHAPES)
def test_gate_fragments_bf16x2_forward(E, H):
    """The forward loader (mma_b16_gates): warp ug's two uint4s of k-tile kt
    at ((kt UG + ug) 32 + lane) 2; n-tile q's b0 = word 2 q, b1 = word 2 q
    + 1, mma_bf16's {B[2 t][n], B[2 t + 1][n]} and {B[2 t + 8][n], B[2 t +
    9][n]} of k-tile kt, n = 8 (4 ug + q) + g. Each weight in one place, each
    word read once, each value bf16(B) rounded to nearest even, the rows
    past Ep + Hp zero; a quarter of the fp32 layout's bytes at the path's
    shapes."""
    wp = _wp(E, H, 1)
    words = pack_gates_b16(wp, E, H)
    hp, kp = gate_units(H), k16(E, H)
    UG = hp // 8
    enc = (E,) if E != 13 else ()
    assert 4 * words.size == U.gate_fragment_bytes(H, enc, BF16)[0]
    if kp == gate_inputs(E) + hp:
        assert 4 * words.size * 4 == 4 * gate_packed_floats(H, enc)
    got = np.zeros((kp, 4 * hp), np.uint32)
    seen = np.zeros(words.size, np.int64)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for ug in range(UG):
        for kt in range(kp // 16):
            base = 8 * ((kt * UG + ug) * 32 + lane)
            for q in range(4):
                n = 8 * (4 * ug + q) + g
                for half in range(2):  # b0, b1
                    idx = base + 2 * q + half
                    seen[idx] += 1
                    lo, hi = _lo_hi(words[idx])
                    got[16 * kt + 2 * t + 8 * half, n] = lo
                    got[16 * kt + 2 * t + 8 * half + 1, n] = hi
    assert (seen == 1).all()
    k, n = np.meshgrid(np.arange(kp), np.arange(4 * hp), indexing="ij")
    want = widened(bf16_bits(weight(wp, k, n, E, H)))
    np.testing.assert_array_equal(got, want)
    assert not want[gate_inputs(E) + hp:].any()
    # the widened value is bf16 round-to-nearest-even: a tie rounds to even
    tie = np.array([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8], np.float32)
    np.testing.assert_array_equal(
        widened(bf16_bits(tie)).view(np.float32), [1.0, 1.0 + 2.0 ** -6])


@pytest.mark.parametrize("E,H", SHAPES)
def test_gate_fragments_bf16x2_transposed(E, H):
    """The backward loader (mma_b16_tiles): n-tile nt's uint2 of k-tile kt
    (16 gate columns) at (kt NT + nt) 32 + lane, {b0, b1} of B^T[16 kt + 2
    t ..][8 nt + g]: the forward's B transposed, each word read once, a
    quarter of the fp32 layout's bytes."""
    wp = _wp(E, H, 2)
    words = pack_gates_t_b16(wp, E, H)
    ep, hp = gate_inputs(E), gate_units(H)
    NT = (ep + hp) // 8
    enc = (E,) if E != 13 else ()
    assert 4 * words.size == U.gate_fragment_bytes(H, enc, BF16)[1] \
        == U.gate_fragment_bytes(H, enc)[1] // 4
    got = np.zeros((4 * hp, ep + hp), np.uint32)
    seen = np.zeros(words.size, np.int64)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    for kt in range(4 * hp // 16):
        for nt in range(NT):
            for half in range(2):
                idx = 2 * ((kt * NT + nt) * 32 + lane) + half
                seen[idx] += 1
                lo, hi = _lo_hi(words[idx])
                got[16 * kt + 2 * t + 8 * half, 8 * nt + g] = lo
                got[16 * kt + 2 * t + 8 * half + 1, 8 * nt + g] = hi
    assert (seen == 1).all()
    k, n = np.meshgrid(np.arange(ep + hp), np.arange(4 * hp), indexing="ij")
    np.testing.assert_array_equal(
        got, widened(bf16_bits(weight(wp, k, n, E, H))).T)


def test_bf16_rows_give_m16n8k16_fragments():
    """x, h and dz as bf16 rows (lane l at column l, TMB apart): for m-tile
    i and k-tile k0, lane L's ldmatrix.trans row k0 + (L & 7) + 8 (L >> 4),
    column 16 i + 8 ((L >> 3) & 1) (lstm_mma.cuh b16_rows) gives mma_bf16's
    A fragment: rows (lanes) g and g + 8, k pairs 2 t and 2 t + 8. The
    eight rows of a matrix hit distinct 16-byte bank groups."""
    K = 32
    rows = [[(k, m) for m in range(TMB)] for k in range(K)]
    for k0 in range(0, K, 16):
        for i in range(4):
            reg = tm._ldmatrix(rows, lambda L: (
                k0 + (L & 7) + 8 * (L >> 4), 16 * i + 8 * ((L >> 3) & 1)),
                trans=True)
            for lane in range(32):
                g, t = lane // 4, lane % 4
                want = [((k0 + 2 * t + kk, 16 * i + g + mm),
                         (k0 + 2 * t + kk + 1, 16 * i + g + mm))
                        for kk, mm in ((0, 0), (0, 8), (8, 0), (8, 8))]
                assert [tuple(r) for r in reg[lane]] == want
    assert len({(r * TMB * 2) // 16 % 8 for r in range(8)}) == 8


def test_rounded_products_rows():
    """grad_rounded_kernel: a window's 64 samples of a row as bf16x2 words
    {s, s + 4} at word 8 (s % 8) + s / 8 (s % 8 < 4); thread (g, tq) loads
    words 8 tq + 4 half .. + 3 of rows g (+ 8): k-step 4 half + c's A
    fragment (M = rows, K = samples) and B fragment, as grad_tf32_tile's
    split_op<true> gave them. The staging writes each word once; a quarter
    warp's 16-byte loads hit distinct banks."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(64, 64)).astype(np.float32)  # [row][sample]
    rows = np.zeros((64, GR_S), np.uint32)
    seen = np.zeros((64, GR_S), np.int64)
    for tid in range(256):
        for q in range(2):
            e = tid + 256 * q
            row, ks = e // 8, e % 8
            v = A[row, 8 * ks:8 * ks + 8]
            for t in range(4):
                rows[row, 8 * t + ks] = (
                    int(bf16_bits(v[t:t + 1])[0])
                    | int(bf16_bits(v[t + 4:t + 5])[0]) << 16)
                seen[row, 8 * t + ks] += 1
    assert (seen[:, :32] == 1).all() and (seen[:, 32:] == 0).all()
    wide = widened(bf16_bits(A))
    for lane in range(32):
        g, tq = lane // 4, lane % 4
        for half in range(2):
            w0 = rows[g, 8 * tq + 4 * half:8 * tq + 4 * half + 4]
            w1 = rows[g + 8, 8 * tq + 4 * half:8 * tq + 4 * half + 4]
            for c in range(4):
                k0 = 8 * (4 * half + c)
                a = [w0[c] << 16, w1[c] << 16, w0[c] & 0xffff0000,
                     w1[c] & 0xffff0000]
                want = [wide[g, k0 + tq], wide[g + 8, k0 + tq],
                        wide[g, k0 + tq + 4], wide[g + 8, k0 + tq + 4]]
                assert [int(x) for x in a] == [int(x) for x in want]
                # B's fragment from the same words: B[n = g][k], [k + 4]
                b = [w0[c] << 16, w0[c] & 0xffff0000]
                assert [int(x) for x in b] == [int(wide[g, k0 + tq]),
                                               int(wide[g, k0 + tq + 4])]
    for half in range(2):
        chunks = {(g * GR_S * 4 + 32 * tq + 16 * half) // 16 % 8
                  for g in range(2) for tq in range(4)}
        assert len(chunks) == 8


def _walk_bytes(hidden, encoder):
    """update_lstm.cu bptt_smem_floats(bf16), counted here in bytes."""
    from drone_tpu_torch.models.lstm import encoder_of, encoder_width, is_cnn
    encoder = encoder_of(encoder)
    E = encoder_width(encoder)
    ep, hp = gate_inputs(E), gate_units(hidden)
    ring = GATE_WARPS * RING
    cnn = is_cnn(encoder)
    widths = () if cnn else tuple(encoder)
    mid = widths[:-1]
    maxw = max(mid, default=0)
    nbuf = 2 if len(widths) >= 3 else (1 if len(widths) == 2 else 0)
    dx_rows = max(ep, E if cnn else max(widths, default=0))
    fwd = 2 * TMB * -(-(ep + hp) // 16) * 16
    if cnn:
        fwd += 4 * 64 * 128 + ring
    else:
        fwd += max(4 * 64 * (13 + nbuf * maxw + (E if widths else 0)), ring)
    bwd = max(2 * TMB * 4 * hp + ring, 4 * 72 * maxw) + 4 * 72 * (dx_rows + 6)
    return max(fwd, bwd)


@pytest.mark.parametrize("hidden,encoder", [
    (128, (64,)), (128, KERNEL_ARCH), (128, ()), (64, (64,)),
    (100, (377, 157)), (8, (32,)), (96, (32, 48, 64)), (20, (36,))])
def test_bf16_walk_sizes(hidden, encoder):
    """The bytes the wrapper passes for the bf16 walk (x, h and dz as bf16
    rows, the warps' fragment rings, the CNN arm's next x, the dense
    encoder's fp32 rows) and its products, the scratch's rows (GF's five
    quantities), within a block; the fp32 arm's unchanged."""
    walk, f, b, prod = U.kernel_smem_bytes(hidden, encoder, BF16)
    assert walk == U.bptt_smem_bytes(hidden, encoder, BF16) \
        == _walk_bytes(hidden, encoder) <= MAX_SMEM
    cnn = encoder is KERNEL_ARCH
    assert prod == (U.PRODUCT_SMEM_BF16 if cnn else U.PRODUCT_SMEM_ROUNDED)
    hp = gate_units(hidden)
    rows16, rows32 = (U.scratch_rows(hidden, encoder, d)
                      for d in (BF16, "float32"))
    assert rows16[U.GF] == 5 * hp and rows32[U.GF] == 6 * hp
    assert [r for i, r in enumerate(rows16) if i != U.GF] == \
        [r for i, r in enumerate(rows32) if i != U.GF]
    U.check_envelope(hidden, encoder, BF16)


def test_main_path_walk_sizes():
    """At the recurrent path's shapes (H 128; E 64 dense, 128 CNN): the
    walk's shared bytes, its fragments a quarter of the fp32 layout's L2
    bytes (24,576 and 32,768 a sample there, 6,144 and 8,192 here)."""
    assert U.bptt_smem_bytes(128, (64,), BF16) == 126656
    assert U.bptt_smem_bytes(128, KERNEL_ARCH, BF16) == 145088
    for enc, per_sample in (((64,), 6144), (KERNEL_ARCH, 8192)):
        f16, b16 = U.gate_fragment_bytes(128, enc, BF16)
        f32, b32 = U.gate_fragment_bytes(128, enc)
        assert (f32, b32) == (4 * f16, 4 * b16)
        assert (f16 + b16) / U.BP_LANES == per_sample


def test_bf16_envelope_takes_every_fp32_shape():
    """Every dense LSTM the fp32 walk takes, the bf16 walk takes too (its
    rings overlap rows it no longer reads), so bfloat16 routes as float32
    does."""
    rng = np.random.default_rng(9)
    took = 0
    for hidden in range(4, 129, 4):
        for n_enc in range(5):
            for _ in range(6):
                encoder = tuple(int(w) for w in
                                rng.integers(1, 4 * hidden + 1, n_enc))
                try:
                    U.check_envelope(hidden, encoder)
                except ValueError:
                    continue
                took += 1
                U.check_envelope(hidden, encoder, BF16)
                assert U.bptt_smem_bytes(hidden, encoder, BF16) \
                    == _walk_bytes(hidden, encoder) <= MAX_SMEM
    assert took > 400


@pytest.mark.parametrize("family", ["dense", "cnn"])
@pytest.mark.parametrize("off_policy", [False, True])
def test_k16_walk_plain_k7_matches_reference(monkeypatch, family,
                                              off_policy):
    """The plain bf16 K7 with every product of the walk as m16n8k16 (the
    gate block's forward, one product of [x; h] in groups of 16, and [dx;
    dh]), the weight products and the CNN arm's tower too, against the
    reference's bf16 mirror, on and off the planes' weights, by H12's rule
    unwidened."""
    tm._emulate(monkeypatch)
    mm = cuda_update_cnn.mm_bf16_k16
    monkeypatch.setattr(lstm_model, "gate_linear", lambda x, h, wi, wh: mm(
        torch.cat([x, h], -1), torch.cat([wi, wh], 1).t()))
    tbl.test_plain_bf16_k7_matches_reference(family, off_policy)
