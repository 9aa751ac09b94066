"""The bf16 tensor-core design of the bfloat16 arms of K10, K7 (both
encoders) and K9/K11 (csrc/mma.cuh mma_bf16, grad_b16_tile; csrc/cnn_mma.cuh
tower_fwd_b16, tower_bwd_b16, pack_tower_kernel<true>), on the CPU.

The kernels multiply with mma.sync m16n8k16 bf16: both operands rounded to
bfloat16, each product exact in float32, 16 products summed in a group
before the group joins the float32 accumulator (the TF32 product grouped
8). `cuda_update_cnn.mm_bf16_k16` is that product in torch; here it takes
the place of the tower's products (`cuda_acting_cnn.tower_linear`,
`cuda_update_cnn.tower_mm`) and of K7's (`cuda_update_lstm.gate_mm`) in the
plain bf16 versions, which must still meet H12's CPU rule against
drone_tpu's bf16 mirrors (tests/test_torch_bf16.py and
tests/test_torch_bf16_lstm.py: at least 99% of the values within rtol 2e-5
/ atol 2e-6, each gradient tensor within 1e-3 of its largest |value|, the
mean difference under a tenth of the one to the fp32 mirror), unwidened.

The layouts the kernels compute with are mirrored in Python: ldmatrix's
fragments from bf16 rows of 72 (the products' A and B registers of
m16n8k16), the packed weights' bf16x2 fragments, and the shared memory and
packed bytes the wrappers pass, which fit a block at the blocks an SM each
kernel runs, the fp32 arm's unchanged.
"""
import numpy as np
import pytest
import torch

from drone_tpu_torch.ops import cuda_acting_cnn, cuda_update_cnn
from drone_tpu_torch.ops import cuda_update_lstm
from drone_tpu_torch.ops.cuda_acting_cnn import KERNEL_ARCH
from drone_tpu_torch.ops.cuda_acting_traj import operand
from tests import test_torch_bf16 as tb
from tests import test_torch_bf16_lstm as tbl

BF16 = "bfloat16"
MAX_SMEM = 232448        # bytes a block of an H100 can take
SM_SMEM = 233472         # bytes an SM has, 1 KB of it reserved per block
TMB = 72                 # a bf16 row of the tile (csrc/cnn_mma.cuh TMB)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _emulate(monkeypatch):
    """The plain versions' tower and gate products as m16n8k16 bf16."""
    mm = cuda_update_cnn.mm_bf16_k16
    monkeypatch.setattr(cuda_acting_cnn, "tower_linear",
                        lambda x, w, b: mm(x, w.t()) + b)
    monkeypatch.setattr(cuda_update_cnn, "tower_mm", mm)
    monkeypatch.setattr(cuda_update_lstm, "gate_mm", mm)


@pytest.mark.parametrize("K", [16, 48, 40])
def test_mm_bf16_k16_rounds_and_groups_sixteen(K):
    """mm_bf16_k16 against numpy: operands rounded to bf16 (nearest even),
    each group of 16 products summed exactly, the groups added in float32
    one after another (a ragged last group at K 40); not float32's product
    of the unrounded operands."""
    rng = np.random.default_rng(K)
    a = rng.normal(size=(5, K)).astype(np.float32)
    b = rng.normal(size=(K, 7)).astype(np.float32)
    got = cuda_update_cnn.mm_bf16_k16(torch.from_numpy(a),
                                      torch.from_numpy(b)).numpy()

    def round_bf16(x):
        bits = x.view(np.uint32).astype(np.uint64)
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        return bits.astype(np.uint32).view(np.float32)

    ar, br = round_bf16(a), round_bf16(b)
    want = np.zeros((5, 7), np.float32)
    for k0 in range(0, K, 16):
        group = ar[:, k0:k0 + 16].astype(np.float64) @ br[k0:k0 + 16]
        want = (want + group.astype(np.float32)).astype(np.float32)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        operand(torch.from_numpy(a), BF16).numpy(), ar)
    assert np.abs(got - a @ b).max() > 1e-4
    # a batch of rows as the tower's (N, patches, K) activations
    a3 = torch.from_numpy(a).reshape(5, 1, K).repeat(1, 3, 1)
    np.testing.assert_array_equal(
        cuda_update_cnn.mm_bf16_k16(a3, torch.from_numpy(b))[:, 2].numpy(),
        want)


def test_k16_plain_k10_matches_reference(monkeypatch):
    """The plain bf16 K10 with its tower's products as m16n8k16 against the
    reference's bf16 mirror, off the planes' weights (every branch taken),
    by H12's rule unwidened."""
    _emulate(monkeypatch)
    tb.test_plain_bf16_cnn_update_matches_reference()


def test_k16_plain_k9_matches_reference(monkeypatch):
    """The plain bf16 K9 (the forward K10 and K7's CNN arm share) with its
    tower's products as m16n8k16 against the reference's bf16 rollout."""
    _emulate(monkeypatch)
    tb.test_plain_bf16_cnn_traj_matches_reference()


@pytest.mark.parametrize("family", ["dense", "cnn"])
@pytest.mark.parametrize("off_policy", [False, True])
def test_k16_plain_k7_matches_reference(monkeypatch, family, off_policy):
    """The plain bf16 K7, both encoders, with its weight products, [dx; dh]
    and (CNN arm) the tower's products as m16n8k16 against the reference's
    bf16 mirror, on and off the planes' weights, by H12's rule unwidened.
    (The kernels' dense arm keeps its products on one TF32 product of
    rounded operands a k-step; the grouping holds the rule there too.)"""
    _emulate(monkeypatch)
    tbl.test_plain_bf16_k7_matches_reference(family, off_policy)


def _ldmatrix(rows, addr, trans):
    """ldmatrix.x4 of 16-bit values: rows[r][c] the tile's values; addr(l)
    = (row, column) lane l gives for row l % 8 of matrix l // 8. Returns
    reg[lane][i] = (lower, upper) values of matrix i that lane receives:
    row lane // 4, columns 2 (lane % 4), + 1; with trans, rows 2 (lane %
    4), + 1 of column lane // 4."""
    out = [[None] * 4 for _ in range(32)]
    for i in range(4):
        mat = [[rows[addr(8 * i + r)[0]][addr(8 * i + r)[1] + c]
                for c in range(8)] for r in range(8)]
        for lane in range(32):
            q, t = lane // 4, lane % 4
            out[lane][i] = ((mat[2 * t][q], mat[2 * t + 1][q]) if trans
                            else (mat[q][2 * t], mat[q][2 * t + 1]))
    return out


def _labels(nrows, ncols):
    return [[(r, c) for c in range(ncols)] for r in range(nrows)]


def test_ldmatrix_fragments_of_rows_k_major():
    """cnn_mma.cuh mma_rows_b16: the A fragment (M = samples, K = rows) by
    ldmatrix.trans from bf16 rows [row][sample], lane l's address row
    (l & 7) + 8 (l >> 4), sample 8 ((l >> 3) & 1): register i of lane (g,
    t) holds A[m][k], A[m][k + 1] with (m, k) = (g + 8 (i & 1), 2 t + 8 (i
    >> 1)), as m16n8k16's row-major A."""
    rows = _labels(16, 16)  # (k, m) of each stored value
    regs = _ldmatrix(rows, lambda l: ((l & 7) + 8 * (l >> 4),
                                      8 * ((l >> 3) & 1)), trans=True)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            m, k = g + 8 * (i & 1), 2 * t + 8 * (i >> 1)
            assert regs[lane][i] == ((k, m), (k + 1, m))


def test_ldmatrix_fragments_of_rows_of_samples():
    """mma_samples_b16 and grad_b16_tile: A (M = rows, K = samples) by
    ldmatrix, lane l's address row (l & 7) + 8 ((l >> 3) & 1), sample 8 (l
    >> 4); B (K = samples, N = rows) of two n-tiles, row (l & 7) + 8 (l >>
    4), sample 8 ((l >> 3) & 1): B register j of n-tile p holds B[k][n],
    B[k + 1][n], (k, n) = (2 t + 8 j, g + 8 p)."""
    rows = _labels(16, 16)  # (row, sample)
    a = _ldmatrix(rows, lambda l: ((l & 7) + 8 * ((l >> 3) & 1),
                                   8 * (l >> 4)), trans=False)
    b = _ldmatrix(rows, lambda l: ((l & 7) + 8 * (l >> 4),
                                   8 * ((l >> 3) & 1)), trans=False)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            m, k = g + 8 * (i & 1), 2 * t + 8 * (i >> 1)
            assert a[lane][i] == ((m, k), (m, k + 1))
            p, j = i >> 1, i & 1
            k, n = 2 * t + 8 * j, g + 8 * p
            assert b[lane][i] == ((n, k), (n, k + 1))


@pytest.mark.parametrize("K, N, sn, sk", [(64, 64, 64, 1), (576, 128, 576, 1),
                                          (128, 576, 1, 576)])
def test_packed_bf16_fragments_cover_each_weight_once(K, N, sn, sk):
    """pack_tower_kernel<true>'s layout, mirrored: uint4 i of a K x N
    product (B[k][n] = W[n sn + k sk]) holds, for lane (g, t) of k-tile kt
    and n-tile pair np, the bf16 pairs (k, k + 1) and (k + 8, k + 9) of n =
    16 np + g, then of n + 8, k = 16 kt + 2 t: m16n8k16's B registers of
    two n-tiles, each weight exactly once."""
    seen = np.zeros(K * N, np.int64)
    NP = N // 16
    for i in range(K * N // 8):
        lane, tile = i % 32, i // 32
        kt, np_ = tile // NP, tile % NP
        g, t = lane // 4, lane % 4
        n, k = 16 * np_ + g, 16 * kt + 2 * t
        for nn in (n, n + 8):
            for kk in (k, k + 1, k + 8, k + 9):
                seen[nn * sn + kk * sk] += 1
        # the B registers of n-tile 2 np (and 2 np + 1): rows 2t, 2t + 1
        # and 2t + 8, 2t + 9 of k-tile kt, column g
        assert (k - 16 * kt, n - 16 * np_) == (2 * t, g)
    assert (seen == 1).all()


def test_bf16_tower_kernels_shared_memory_and_packing():
    """The byte counts the wrappers pass for the bf16 arm (K10's and K7's
    tower, K9's forward, the products) and K10's backward blocks: each
    within a block's limit at the blocks an SM its kernel runs (the
    forward two, K10's backward two and K7's one, csrc/cnn_mma.cuh
    TBB_PER_SM), the packed weights a quarter of 3xTF32's; the fp32 arm's
    unchanged."""
    C, U, A = cuda_update_cnn, cuda_update_lstm, cuda_acting_cnn
    fwd, bwd, packed, blocks = C.tower_layout(BF16)
    # W0's and W1's bf16 fragments, then rows of 72 floats: 12 splat rows,
    # two patches and two conv0 outputs as bf16 (half a row each), conv1's
    # output in fp32 and again in bf16
    assert fwd == A.TOWER_FWD_SMEM_BF16 == 4 * (
        (64 * 64 + 256 * 64) // 2 + 72 * (12 + 64 + 64 + 64 + 32)) == 108928
    # h (128 fp32 rows) fits over the conv0 outputs and conv1's fp32 rows
    assert 128 <= 64 + 64
    # splat rows, then dzt, four patches, four conv0 outputs, dz1 as bf16,
    # then the row sums of dz1 (4 x 64) and of dz0 (2 x 256)
    assert bwd == 4 * (72 * 12 + 36 * (128 + 256 + 256 + 64) + 256 + 512) \
        == 107904
    assert packed == (64 * 64 + 2 * 256 * 64 + 2 * 576 * 128) // 2 == 92160
    assert 4 * packed == C.PACKED_FLOATS
    assert A.FWD_PACKED_FLOATS_BF16 * 4 == A.FWD_PACKED_FLOATS
    assert blocks == 2 * 132 == C.BWD_BLOCKS_BF16
    assert 2 * (fwd + 1024) <= SM_SMEM and 2 * (bwd + 1024) <= SM_SMEM
    walk, f7, b7, prod = U.kernel_smem_bytes(128, KERNEL_ARCH, BF16)
    assert (f7, b7) == (fwd, bwd)
    assert prod == U.PRODUCT_SMEM_BF16 == 2 * 2 * 64 * TMB * 2 == 36864
    # the bf16 walk's own rows (tests/test_torch_bf16_walk.py)
    assert walk == U.bptt_smem_bytes(128, KERNEL_ARCH, BF16) == 145088
    assert max(walk, f7, b7, prod) <= MAX_SMEM
    # the dense arm's bf16 products: bf16x2 rows of 36 words beside A's
    # fp32 rows (update_lstm.cu GR_SMEM)
    assert U.kernel_smem_bytes(128, (64,), BF16)[1:] == [
        0, 0, U.PRODUCT_SMEM_ROUNDED]
    assert U.PRODUCT_SMEM_ROUNDED == 2 * 2 * 64 * 36 * 4 + 2 * 64 * 68 * 4 \
        == 71680
    # the fp32 arm's, as before
    assert C.tower_layout() == (109952, 206208, 4 * 92160, 132)
    assert A.TOWER_FWD_SMEM == 109952
    assert U.kernel_smem_bytes(128, KERNEL_ARCH)[1:] == [109952, 206208,
                                                         69632]
    with pytest.raises(ValueError):
        C.tower_layout("float16")
