"""CNN PPO update kernel (K10): one minibatch of the patch-CNN policy's
forward and hand-written backward.

Counterpart of `drone_tpu/ops/pallas_update_cnn.py`. The kernels are in
`csrc/update_cnn.cu`; `ppo_cnn_update_plain` is the plain PyTorch version,
the reference's `_cnn_block_grads` (`cnn_forward`, the PPO head's
gradients, `cnn_encoder_bwd`) in batch-major torch over the gathered
minibatch. A whole minibatch would hold the rendered patches and conv0's
output for every sample (~19 GB each at 2.1 M samples), so the plain
version walks the samples in chunks and adds the chunks' sums: another
order than the reference's, inside the stated tolerance.
`ppo_cnn_update_cuda` takes the plain version for CPU tensors only; on a
CUDA tensor it launches the kernels.

The kernels run the tower's products (conv0, conv1, the trunk, dX2, gW1,
dX1, gW0) on the tensor cores in 3xTF32 (`csrc/cnn_mma.cuh`, whose
forward the acting kernels run too): each fp32
operand split into two TF32 halves, three products a pair. `mm_3xtf32`
is that product in torch, which `tower_linear` and `tower_mm` can be
swapped for to see what the precision costs the plain version.

Returns (grads (P,) in the flat kernel order, stat sums (N_UPSTATS,)) as
`cuda_update.ppo_update_cuda`: gradients are sums scaled by inv_m, and
log_std's is its stat sums ST_DLS* minus ent_coef.

`compute_dtype="bfloat16"` is the reference's bf16 operand arm of K10:
every product (the forward, the heads' gradients, dh, gWt, dX2, gW1, dX1,
gW0) takes its operands rounded to bfloat16 (`cuda_acting_traj.operand`,
the reference's `_dot32`) and sums in float32; the bias sums stay float32.
The kernels' bf16 arm runs the tower's products (and gWt) on the bf16
tensor cores, 16 products summed in a group (`mm_bf16_k16` emulates it).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from drone_tpu_torch.models.cnn import (
    CnnArch,
    CnnGeom,
    cnn_all_weights,
    cnn_kernel_offsets,
)
from drone_tpu_torch.ops import cuda_build
from drone_tpu_torch.ops.cuda_acting_cnn import (
    KERNEL_ARCH,
    ROW_STRIDE,
    TILE,
    TOWER_FWD_SMEM,
    TOWER_FWD_SMEM_BF16,
    check_envelope,
    cnn_forward,
    window_index,
)
from drone_tpu_torch.ops.cuda_acting_traj import N_TRAJ, bf16_flag, operand
from drone_tpu_torch.ops.cuda_update import (
    N_UPSTATS,
    ST_DLS0,
    UpdateConsts,
    branch_counts,
    check_cuda_tensor,
    gather_minibatch,
    head_grads,
)
from drone_tpu_torch.pixels import grid_table, patch_grid

# the plain version's samples per chunk
PLAIN_CHUNK = 16384
# kernel limits (csrc/update_cnn.cu, csrc/cnn_mma.cuh)
FWD_BLOCKS = 264          # the forward's blocks (two an SM)
BWD_BLOCKS = 132          # the tower backward's blocks (one an SM)
BWD_BLOCKS_BF16 = 264     # the bf16 arm's (cnn_mma.cuh TBB_PER_SM an SM)
MAX_CHUNK = 4096          # lanes of one split-K chunk of the trunk's product
MAX_SCRATCH = 262144      # samples of one chunk of steps (~0.7 GB scratch)
FP_W = 645 + N_UPSTATS    # a forward block's partial row: heads, stats
BP_W = 20608              # a backward block's: W0 b0 W1 b1
GPT = 128 * 577           # a product partial row
PACKED_FLOATS = 4 * 92160  # the tower's packed (big, small) weights
# shared rows of a backward tile (splat scalars, dzt, four patches, conv0's
# four outputs, dz1; TILE samples each), ROW_STRIDE floats apart; the
# forward tile's are cuda_acting_cnn's (TOWER_FWD_SMEM)
TOWER_BWD_ROWS = 12 + 128 + 256 + 256 + 64
TOWER_BWD_SMEM = 4 * ROW_STRIDE * TOWER_BWD_ROWS   # 206,208
# The bf16 arm (cnn_mma.cuh PKB_*, TBB_*): the packed weights as bf16 pairs;
# the backward tile's splat scalars in fp32 rows, dzt, the patches, conv0's
# outputs and dz1 in bf16 rows (half a row's floats each), then the row sums
# of dz1 (4 x 64 floats) and of dz0 (2 x 256)
PACKED_FLOATS_BF16 = (64 * 64 + 2 * 256 * 64 + 2 * 576 * 128) // 2  # 92,160
TOWER_BWD_SMEM_BF16 = 4 * (ROW_STRIDE * (12 + (128 + 256 + 256 + 64) // 2)
                           + 4 * 64 + 2 * 256)                 # 107,904


def tower_layout(compute_dtype: str = "float32") -> tuple[int, int, int,
                                                          int]:
    """An arm's tower kernels as the C entry points check them: (the
    forward tile's shared bytes, the backward tile's, the packed weights'
    floats, K10's backward blocks)."""
    if bf16_flag(compute_dtype):
        return (TOWER_FWD_SMEM_BF16, TOWER_BWD_SMEM_BF16, PACKED_FLOATS_BF16,
                BWD_BLOCKS_BF16)
    return TOWER_FWD_SMEM, TOWER_BWD_SMEM, PACKED_FLOATS, BWD_BLOCKS


def tf32_split(x):
    """(big, small) of float32 x as the kernels split an operand of a
    3xTF32 product: big = x rounded to nearest TF32 (10 mantissa bits),
    ties away from zero, as cvt.rna.tf32.f32; small = the same of x - big.
    By bit operations, for finite x."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    big = rna(x)
    return big, rna(x - big)


def mm_3xtf32(a, b):
    """a @ b as the tensor cores compute it in 3xTF32: small.big +
    big.small + big.big, each product exact in float32."""
    ab, a_s = tf32_split(a)
    bb, bs = tf32_split(b)
    return (a_s @ bb + ab @ bs) + ab @ bb


def mm_bf16_k16(a, b):
    """a (..., K) @ b (K, N) as the bf16 tensor cores' m16n8k16 product
    computes it: both operands rounded to bfloat16 (nearest even), each
    product exact, each group of 16 k-terms summed (here exactly, in
    float64) before it joins the float32 accumulator, group after group."""
    a16 = operand(a, "bfloat16").double()
    b16 = operand(b, "bfloat16").double()
    acc = None
    for k0 in range(0, a.shape[-1], 16):
        part = (a16[..., k0:k0 + 16] @ b16[k0:k0 + 16]).float()
        acc = part if acc is None else acc + part
    return acc


def tower_mm(a, b):
    """a @ b for the tower's backward products (dX2, gW1, dX1, gW0), which
    the kernels run in 3xTF32; mm_3xtf32 can take its place."""
    return a @ b


def cnn_encoder_bwd(dh, acts, enc_weights, geom: CnnGeom,
                    compute_dtype: str = "float32"):
    """Hand-written backward of `cnn_encode`: dh (N, hidden) = d loss / d
    trunk output -> [gW0, gb0, gW1, gb1, gWt, gbt]. acts from
    cnn_encode(want_acts=True)."""
    def op(x):
        return operand(x, compute_dtype)

    W0, b0, W1, b1, Wt, bt = enc_weights
    _, X0, Y0, Y1, X2, h = acts
    n, c0, c1 = dh.shape[0], W0.shape[0], W1.shape[0]
    dzt = dh * (h > 0.0).to(dh.dtype)
    gWt = op(dzt).t() @ op(X2)
    gbt = dzt.sum(0)
    # conv1: un-concat dX2, relu-mask, the weight gradient against the
    # windows' conv0 outputs, and the input gradient routed back to the
    # feeding conv0 patches (patchify convs: each patch feeds one window)
    dz1 = (tower_mm(op(dzt), op(Wt)).view(n, geom.n_q1, c1)
           * (Y1 > 0.0).to(dh.dtype))
    idx = window_index(geom, dh.device)
    X1 = Y0[:, idx].reshape(n, geom.n_q1, -1)
    gW1 = tower_mm(op(dz1).reshape(-1, c1).t(),
                   op(X1).reshape(-1, X1.shape[-1]))
    gb1 = dz1.sum((0, 1))
    dX1 = tower_mm(op(dz1), op(W1)).view(n, -1, c0)
    dY0 = torch.empty_like(Y0)
    dY0[:, idx.reshape(-1)] = dX1
    # conv0 against the rendered patches
    dz0 = dY0 * (Y0 > 0.0).to(dh.dtype)
    gW0 = tower_mm(op(dz0).reshape(-1, c0).t(),
                   op(X0).reshape(-1, X0.shape[-1]))
    gb0 = dz0.sum((0, 1))
    return [gW0, gb0, gW1, gb1, gWt, gbt]


def cnn_block_grads(X, a, logp_old, v_old, adv, ret, weights, gx, gy,
                    geom: CnnGeom, co: UpdateConsts,
                    compute_dtype: str = "float32"):
    """Forward + hand-written backward over a batch of samples (the
    reference's _cnn_block_grads). Returns (the 10 gradient tensors in
    kernel order without log_std, stats (S, 8))."""
    def op(x):
        return operand(x, compute_dtype)

    hw, vw = weights[6][0], weights[7][0]
    m, v, acts = cnn_forward(X, weights, gx, gy, geom, want_acts=True,
                             compute_dtype=compute_dtype)
    h = acts[-1]
    dm, g_v, stats = head_grads(m, v, a, logp_old, v_old, adv, ret,
                                weights[8], co)
    heads = [op(dm).t() @ op(h), dm.sum(0), op(g_v)[None] @ op(h),
             g_v.sum(0, keepdim=True)]
    dh = op(dm) @ op(hw) + op(g_v)[:, None] @ op(vw)
    return (cnn_encoder_bwd(dh, acts, weights[:6], geom, compute_dtype)
            + heads), stats


def _chunks(samples, chunk):
    for s0 in range(0, samples[0].shape[0], chunk):
        yield [x[s0:s0 + chunk] for x in samples]


@torch.no_grad()
def ppo_cnn_update_plain(planes, advret, perm_mb, theta, arch,
                         co: UpdateConsts, rbl: int, ent_coef: float = 0.0,
                         compute_dtype: str = "float32"):
    """Plain PyTorch version of K10. planes (T, N_TRAJ, N) from the CNN
    rollout; advret (2, T, N); perm_mb the minibatch's row blocks of rbl
    lanes; theta the flat parameters of arch."""
    bf16_flag(compute_dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    arch = CnnArch(*arch)
    weights = cnn_all_weights(theta, arch)
    gx, gy = patch_grid(arch.res, arch.p0, theta.device)
    samples = gather_minibatch(planes, advret, perm_mb, rbl)
    grads = torch.zeros_like(theta)
    views = cnn_all_weights(grads, arch)
    g_views = [*views[:6], *views[6], *views[7]]
    st = torch.zeros(N_UPSTATS, device=theta.device)
    for X, a, logp_old, v_old, adv, ret in _chunks(samples, PLAIN_CHUNK):
        g, stats = cnn_block_grads(X, a, logp_old, v_old, adv, ret, weights,
                                   gx, gy, arch.geom, co, compute_dtype)
        for dst, src in zip(g_views, g):
            dst += src.reshape(dst.shape)
        st += stats.sum(0)
    views[8][:] = st[ST_DLS0:] - ent_coef
    return grads, st


@torch.no_grad()
def cnn_head_branch_counts(planes, advret, perm_mb, theta, arch,
                           co: UpdateConsts, rbl: int,
                           compute_dtype: str = "float32") -> dict:
    """cuda_update.head_branch_counts for the CNN: how many samples of a
    minibatch take each branch of the head's subgradients at theta."""
    arch = CnnArch(*arch)
    weights = cnn_all_weights(theta, arch)
    gx, gy = patch_grid(arch.res, arch.p0, theta.device)
    samples = gather_minibatch(planes, advret, perm_mb, rbl)
    m, v = [], []
    for X, *_ in _chunks(samples, PLAIN_CHUNK):
        mc, vc = cnn_forward(X, weights, gx, gy, arch.geom,
                             compute_dtype=compute_dtype)
        m.append(mc)
        v.append(vc)
    _, a, logp_old, v_old, adv, ret = samples
    return branch_counts(torch.cat(m), torch.cat(v), a, logp_old, v_old, adv,
                         ret, weights[8], co)


def pick_chunk_steps(T: int, NL: int) -> int:
    """Steps of one kernel chunk: the largest divisor of T whose samples
    stay within MAX_SCRATCH."""
    for tch in range(T, 0, -1):
        if T % tch == 0 and tch * NL <= MAX_SCRATCH:
            return tch
    return 1


def chunk_lanes(NL: int) -> int:
    """Lanes of one split-K chunk: the largest power of two up to MAX_CHUNK
    that divides the minibatch's lanes."""
    ck = MAX_CHUNK
    while NL % ck:
        ck //= 2
    return ck


def ppo_cnn_update_kernel(planes, advret, perm_mb, theta, arch,
                          co: UpdateConsts, rbl: int, ent_coef: float = 0.0,
                          compute_dtype: str = "float32"):
    """Launch K10 (csrc/update_cnn.cu; its bf16 arm under bfloat16). Same
    contract as ppo_cnn_update_plain."""
    bf16 = bf16_flag(compute_dtype)
    arch = CnnArch(*arch)
    check_envelope(arch)
    T, _, n = planes.shape
    if rbl % 128 or n % rbl:
        raise ValueError(f"row blocks of {rbl} lanes: the kernel needs a "
                         f"multiple of 128 that divides {n}")
    _, P = cnn_kernel_offsets(KERNEL_ARCH)
    check_cuda_tensor("planes", planes, torch.float32, (T, N_TRAJ, n))
    check_cuda_tensor("advret", advret, torch.float32, (2, T, n))
    check_cuda_tensor("perm_mb", perm_mb, torch.int32, (perm_mb.numel(),))
    check_cuda_tensor("theta", theta, torch.float32, (P,))
    dev = planes.device
    NL = perm_mb.numel() * rbl
    tch = pick_chunk_steps(T, NL)
    CK = chunk_lanes(NL)
    n_tiles = tch * NL // TILE
    fwd_smem, bwd_smem, packed, bwd_blocks = tower_layout(compute_dtype)
    Gf, Gb = min(FWD_BLOCKS, n_tiles), min(bwd_blocks, n_tiles)
    n_chunks, nk = T // tch, tch * NL // CK
    pk = torch.empty(packed, device=dev)
    grid = grid_table(arch.res, arch.p0, dev)
    x2s = torch.empty(tch * 576 * NL, device=dev)
    dzs = torch.empty(tch * 128 * NL, device=dev)
    fpart = torch.empty(n_chunks * Gf, FP_W, device=dev)
    bpart = torch.empty(n_chunks * Gb, BP_W, device=dev)
    gpart = torch.empty(n_chunks * nk, GPT, device=dev)
    grads = torch.empty(P, device=dev)
    stats = torch.empty(N_UPSTATS, device=dev)
    ptrs = np.array([t.data_ptr() for t in (
        planes, advret, perm_mb, theta, pk, grid, x2s, dzs, fpart, bpart,
        gpart, grads, stats)], np.uint64)
    dims = np.array([n, T, rbl, NL, tch, CK, Gf, Gb, fwd_smem, bwd_smem,
                     bf16], np.int32)
    consts = np.array([co.inv_m, 1.0 - co.clip_eps, 1.0 + co.clip_eps,
                       co.clip_eps, co.vf_clip, 0.5 * co.vf_coef, ent_coef],
                      np.float32)
    fn = cuda_build.load("update_cnn").drone_cnn_update
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(ptrs.ctypes.data, dims.ctypes.data, consts.ctypes.data,
                 torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "drone_cnn_update")
    ppo_cnn_update_cuda.launches += 1
    ppo_cnn_update_cuda.bf16_launches += bf16
    return grads, stats


def ppo_cnn_update_cuda(planes, advret, perm_mb, theta, arch,
                        co: UpdateConsts, rbl: int, ent_coef: float = 0.0,
                        compute_dtype: str = "float32"):
    """One CNN PPO minibatch gradient pass over the trajectory planes: the
    kernels on CUDA tensors, the plain version on CPU tensors. perm_mb:
    (n_sel,) int32 row-block indices, block i covering lanes [i*rbl,
    (i+1)*rbl). Returns (grads (P,), stat sums (8,))."""
    run = (ppo_cnn_update_plain if planes.device.type == "cpu"
           else ppo_cnn_update_kernel)
    return run(planes, advret, perm_mb, theta, arch, co, rbl, ent_coef,
               compute_dtype)


ppo_cnn_update_cuda.launches = 0
ppo_cnn_update_cuda.bf16_launches = 0  # of them, the bf16 arm's
