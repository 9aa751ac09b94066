"""K2, the trajectory rollout kernel: its plain version against drone_tpu's.

`drone_tpu_torch.ops.traj_rollout_cuda` runs its plain PyTorch version on
CPU tensors; it is held here to `traj_act_rollout_pallas_planes` in
interpret mode on the same weights (carried across by `params_from_flax`
and flattened into the trainer's buffer). The towers sum in another order
than the reference's W^T @ x and torch's tanh, exp, log, sin and cos differ
from XLA's by a few ulp, so the planes and the final state are held at
rtol 2e-5 / atol 2e-6 over 3 steps, as tests/test_torch_cuda_acting.py
holds K5; episode counts are exact.

The kernel itself runs only on the card (chip_smoke.py). What it reads is
checked here: a mirror of csrc/acting_traj.cu's device pack, read back by
the kernel's fragment indices, must rebuild the module's weights; its
layout must take the towers the fp32 kernel took; and the plain version
with its products in 3xTF32, as the kernel runs them, must still hold the
reference's planes.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import drone_tpu
from drone_tpu.models import ActorCritic as FlaxActorCritic
from drone_tpu.ops.pallas_acting_traj import traj_act_rollout_pallas_planes
from drone_tpu_torch import env as tenv
from drone_tpu_torch import types as ttypes
from drone_tpu_torch.models import ActorCritic, params_from_flax
from drone_tpu_torch.ops import cuda_acting_traj, cuda_update_cnn
from drone_tpu_torch.ops import traj_rollout_cuda
from drone_tpu_torch.ops.cuda_acting import MAX_HIDDEN
from tests.helpers import pack_fstate_batch


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policies(hidden, seed=0, log_std=-0.5):
    """The same weights in both packages; actions of order 1."""
    params = FlaxActorCritic(hidden=hidden).init(jax.random.PRNGKey(seed),
                                                 jnp.zeros((1, 13)))
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(p["actor_mean"]["kernel"].shape[0],
                                         4)))
    p["actor_mean"]["kernel"] = q.astype(np.float32)
    p["log_std"] = np.full(4, log_std, np.float32)
    model = ActorCritic(hidden)
    model.load_state_dict(params_from_flax({"params": p}))
    model.flatten_()
    return {"params": p}, model


@pytest.mark.parametrize("stochastic", [False, True])
def test_plain_traj_matches_pallas_kernel(stochastic):
    N, T = 256, 3
    over = dict(horizon=2)  # every lane resets inside the window
    jp = drone_tpu.types.default_params("hover", **over)
    jenv = drone_tpu.DroneEnv(params=jp)
    env = tenv.DroneEnv(params=ttypes.default_params(**over), device="cpu")
    fparams, model = _policies((32, 32))
    j_final, j_planes, j_stats = traj_act_rollout_pallas_planes(
        jenv.init_batch(3, N), fparams, jp, jenv.statics, T,
        lanes_per_block=N, interpret=True, stochastic=stochastic)
    launches = traj_rollout_cuda.launches
    t_final, t_planes, t_stats = traj_rollout_cuda(
        env.init_batch(3, N), model.flat, model.hidden, env.params,
        env.statics, T, stochastic=stochastic)
    assert traj_rollout_cuda.launches == launches  # CPU tensors: no kernel
    want = np.asarray(j_planes).reshape(T, cuda_acting_traj.N_TRAJ, N)
    assert t_planes.shape == (T, cuda_acting_traj.N_TRAJ, N)
    for p in range(cuda_acting_traj.N_TRAJ):
        np.testing.assert_allclose(t_planes[:, p].numpy(), want[:, p],
                                   rtol=2e-5, atol=2e-6, err_msg=f"plane {p}")
    np.testing.assert_allclose(t_final.fstate().numpy(),
                               pack_fstate_batch(j_final), rtol=2e-5,
                               atol=2e-6)
    assert float(t_stats["episodes"]) == float(j_stats["episodes"]) >= N
    np.testing.assert_allclose(float(t_stats["reward_sum"]),
                               float(j_stats["reward_sum"]), rtol=1e-4)


def _pack_as_the_kernel_does(theta, lay):
    """csrc/acting_traj.cu pack_traj_kernel by the layout's ints: float4 e <
    2 f4 of the fragments (tower e // f4), then each tower's padded biases.
    A fragment float4 of lane 4 g + t of tile (kt, nt) holds the (big,
    small) halves of B = W^T at rows k0, k1 (k0 = 8 kt + t, k1 = k0 + 4; a
    head after hidden layers in pair order, k0 = 8 kt + 2 t, k1 = k0 + 1)
    and column 8 nt + g, the critic's value at head column 4."""
    ints = lay["ints"]
    L, f4, nb = int(ints[0]), lay["f4"], lay["nb"]
    offs = ints[5 + MAX_HIDDEN:-1].reshape(2, MAX_HIDDEN + 1)
    out = torch.zeros(lay["wfl"])
    frags = out[:8 * f4].view(2, f4, 4)
    for tw in (0, 1):
        for li, y in enumerate(lay["layers"]):
            head = li == L
            nout = (1 if tw else 4) if head else y["nout"]
            hc = 4 if head and tw else 0
            W = theta[offs[tw, li]:offs[tw, li] + nout * y["nin"]].reshape(
                nout, y["nin"])
            b = theta[offs[tw, li] + nout * y["nin"]:][:nout]
            NT = -(-y["nout"] // 8)
            for f in range(-(-y["nin"] // 8) * NT * 32):
                kt, nt = divmod(f // 32, NT)
                g, t = (f % 32) // 4, f % 4
                k0 = 8 * kt + (2 * t if head and L else t)
                k1 = k0 + (1 if head and L else 4)
                o = 8 * nt + g - hc
                v = torch.zeros(2)
                if 0 <= o < nout:
                    for h, k in enumerate((k0, k1)):
                        if k < y["nin"]:
                            v[h] = W[o, k]
                big, small = cuda_update_cnn.tf32_split(v)
                frags[tw, y["fo"] + f] = torch.cat([big, small])
            bo = 8 * f4 + tw * nb + y["bo"]
            out[bo + hc:bo + hc + nout] = b
    return out


def _read_as_the_kernel_does(packed, lay, tw, li):
    """Layer li of tower tw from the packed buffer by the kernel's reads:
    (big B, small B) (K x N padded) and the padded bias."""
    L, f4, nb = int(lay["ints"][0]), lay["f4"], lay["nb"]
    y = lay["layers"][li]
    K, N = -(-y["nin"] // 8) * 8, -(-y["nout"] // 8) * 8
    frags = packed[:8 * f4].view(2, f4, 4)[tw, y["fo"]:y["fo"] + K * N // 2]
    frags = frags.reshape(K // 8, N // 8, 32, 4)
    k, n = torch.arange(K)[:, None], torch.arange(N)[None, :]
    if li == L and L:  # regs_mma: unit 8 kt + 2 t + h at lane t, half h
        lane, h = 4 * (n % 8) + (k % 8) // 2, k % 2
    else:              # warp_mma: row 8 kt + t + 4 h
        lane, h = 4 * (n % 8) + k % 4, (k % 8) // 4
    big = frags[k // 8, n // 8, lane, h]
    small = frags[k // 8, n // 8, lane, 2 + h]
    bo = 8 * f4 + tw * nb + y["bo"]
    return big, small, packed[bo:bo + N]


@pytest.mark.parametrize("hidden", [(), (16,), (64, 64), (20, 40, 8)])
def test_kernel_layout_stages_the_towers(hidden):
    """A mirror of the device pack, read back by the kernel's fragment
    indices, rebuilds each layer's W^T (as its TF32 halves) and bias from
    the flat buffer exactly, the critic's value at head column 4."""
    g = torch.Generator().manual_seed(1)
    model = ActorCritic(hidden, generator=g)
    torch.nn.init.normal_(model.actor_mean.weight, generator=g)
    torch.nn.init.normal_(model.critic_value.bias, generator=g)
    flat = model.flatten_().detach()
    lay = cuda_acting_traj.traj_layout(hidden)
    assert lay["wfl"] % 4 == 0 and lay["hf"] % 4 == 0
    packed = _pack_as_the_kernel_does(flat, lay)
    fan = [13, *hidden]
    for tw, (tower, head, cols) in enumerate(
            (("actor", model.actor_mean, range(4)),
             ("critic", model.critic_value, [4]))):
        lins = [getattr(model, f"{tower}_h{i}") for i in range(len(hidden))]
        for li, lin in enumerate([*lins, head]):
            big, small, bias = _read_as_the_kernel_does(packed, lay, tw, li)
            want = torch.zeros(big.shape)
            cols_l = list(cols) if lin is head else range(lin.out_features)
            want[:fan[li], cols_l] = lin.weight.detach().t()
            wb, ws = cuda_update_cnn.tf32_split(want)
            assert torch.equal(big, wb) and torch.equal(small, ws), (tw, li)
            want_b = torch.zeros(bias.shape)
            want_b[cols_l] = lin.bias.detach()
            assert torch.equal(bias, want_b), (tw, li)
    ls_off = int(lay["ints"][-1])
    torch.testing.assert_close(flat[ls_off:ls_off + 4], model.log_std.detach())


def _fp32_k2_took(hidden):
    """The fp32 K2's envelope: at most 8 hidden layers of width <= 256, both
    towers' weights (W^T, outputs padded to 16, and biases; a tower rounded
    up to 4 floats) and a 128-lane block's activation columns in a block's
    shared memory."""
    if len(hidden) > 8 or any(w > 256 for w in hidden):
        return False
    n_w = 0
    for n_head in (4, 1):
        nin, tower = 13, 0
        for w in hidden:
            tower += (nin + 1) * (-(-w // 16) * 16)
            nin = w
        n_w += -(-(tower + (nin + 1) * n_head) // 4) * 4
    n_buf = 2 if len(hidden) >= 3 else (1 if len(hidden) == 2 else 0)
    maxw = max((-(-w // 16) * 16 for w in hidden), default=0)
    return 4 * (n_w + (16 + n_buf * maxw) * 128) <= 232448 - 256


@pytest.mark.parametrize("hidden", [(64, 64), (32, 48, 20), (128, 128), (),
                                    (256, 256)])
def test_traj_layout_keeps_the_fp32_envelope(hidden):
    """traj_layout takes every tower the fp32 K2 took and refuses the ones
    it refused (train.build routes as before), and what it takes fits a
    block's shared memory."""
    if not _fp32_k2_took(hidden):
        with pytest.raises(ValueError):
            cuda_acting_traj.traj_layout(hidden)
        return
    lay = cuda_acting_traj.traj_layout(hidden)
    assert 32 <= lay["bl"] <= 512 and lay["bl"] % 32 == 0
    assert lay["smem"] == 4 * (lay["hf"] + lay["wsm"] * 8 * lay["f4"]
                               + lay["rows"] * (lay["bl"] + 8))
    assert lay["smem"] <= 232448 - 256
    # the obs, then ping and pong rows of the widest stored layer
    mw = max((-(-w // 8) * 8 for w in hidden[:-1]), default=0)
    assert lay["rows"] == 16 + min(2, max(len(hidden) - 1, 0)) * mw


@pytest.mark.parametrize("stochastic", [False, True])
def test_3xtf32_plain_traj_matches_pallas_kernel(monkeypatch, stochastic):
    """The plain K2 with both towers' products in 3xTF32, as the kernel
    runs them (cuda_update_cnn.mm_3xtf32 in tower_forward), still holds
    the reference's planes at the serving tolerance."""
    mm = cuda_update_cnn.mm_3xtf32
    calls = []

    def tower_forward(x, weights):
        calls.append(x.shape[0])
        for li, (w, b) in enumerate(weights):
            x = mm(x, w.t()) + b
            if li < len(weights) - 1:
                x = torch.tanh(x)
        return x

    monkeypatch.setattr(cuda_acting_traj, "tower_forward", tower_forward)
    test_plain_traj_matches_pallas_kernel(stochastic)
    assert len(calls) == 2 * 3  # both towers, 3 steps: the emulation ran


def test_flat_parameters_are_the_module_parameters():
    model = ActorCritic((16, 8), generator=torch.Generator().manual_seed(3))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    flat = model.flatten_()
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    flat.add_(1.0)  # the module sees writes to the buffer
    assert torch.equal(model.log_std.detach(), before["log_std"] + 1.0)


def test_kernel_refuses_cpu_tensors_and_wide_towers():
    env = tenv.DroneEnv(device="cpu")
    model = ActorCritic((16, 16))
    flat = model.flatten_()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_acting_traj.traj_rollout_kernel(env.init_batch(0, 8), flat,
                                             model.hidden, env.params,
                                             env.statics, 2)
    with pytest.raises(ValueError):
        cuda_acting_traj.traj_layout((256, 256))


def test_plane_layout_matches_the_kernels_header():
    """K2 writes and K3 reads the planes in csrc/policy.cuh's layout; the
    host side (and the reference) must agree with it."""
    import re

    from drone_tpu.ops import pallas_acting_traj as PAT
    from drone_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "policy.cuh").read_text()
    header = {name: ttypes.OBS_DIM + int(k) for name, k in re.findall(
        r"constexpr int (N_TRAJ|TP_\w+) = OBS_DIM \+ (\d+);",
        src.replace("= OBS_DIM;", "= OBS_DIM + 0;"))}
    names = ("N_TRAJ", "TP_ACT0", "TP_LOGP", "TP_VAL", "TP_REW", "TP_DONE")
    assert header == {name: getattr(cuda_acting_traj, name) for name in names}
    assert header == {name: getattr(PAT, name) for name in names}
    half = re.search(r"HALF_LOG_2PI = ([0-9.]+)f;", src).group(1)
    assert np.float32(half) == np.float32(cuda_acting_traj.HALF_LOG_2PI)
    for name in ("acting_traj.cu", "update.cu"):
        assert "TP_VAL =" not in (cuda_build.CSRC / name).read_text()
