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
checked here: an emulation of csrc/acting_traj.cu's weight staging, by the
layout ints the wrapper passes, must reproduce the module's towers.
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
from drone_tpu_torch.ops import cuda_acting_traj, traj_rollout_cuda
from drone_tpu_torch.ops.cuda_acting import MAX_HIDDEN
from tests.helpers import pack_fstate_batch


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


def _stage_as_the_kernel_does(theta, ints, src, n_head):
    """csrc/acting_traj.cu stage_tower: the flat buffer -> policy.cuh's
    shared-memory layout, by the layout ints."""
    n_hidden, head_off, n_weights = int(ints[0]), int(ints[1]), int(ints[2])
    widths = [int(w) for w in ints[4:4 + n_hidden]]
    offs = ints[4 + MAX_HIDDEN:4 + MAX_HIDDEN + n_hidden]
    sw = torch.zeros(n_weights)
    nin = 13
    for w, off, s in zip(widths, offs, src):
        npad = -(-w // 16) * 16
        W = theta[s:s + w * nin].reshape(w, nin)
        b = theta[s + w * nin:s + w * nin + w]
        blk = torch.zeros(nin + 1, npad)
        blk[:nin, :w] = W.t()
        blk[nin, :w] = b
        sw[off:off + (nin + 1) * npad] = blk.reshape(-1)
        nin = w
    s = int(src[n_hidden])
    W = theta[s:s + n_head * nin].reshape(n_head, nin)
    b = theta[s + n_head * nin:s + n_head * nin + n_head]
    sw[head_off:head_off + (nin + 1) * n_head] = torch.cat(
        [W.t(), b[None]]).reshape(-1)
    return sw, widths, offs, head_off


def _tower_from_shared(sw, widths, offs, head_off, n_head, obs):
    x, nin = obs, 13
    for w, off in zip(widths, offs):
        npad = -(-w // 16) * 16
        blk = sw[off:off + (nin + 1) * npad].reshape(nin + 1, npad)
        x = torch.tanh(x @ blk[:nin] + blk[nin])[:, :w]
        nin = w
    head = sw[head_off:head_off + (nin + 1) * n_head].reshape(nin + 1, n_head)
    return x @ head[:nin] + head[nin]


@pytest.mark.parametrize("hidden", [(), (16,), (64, 64), (20, 40, 8)])
def test_kernel_layout_stages_the_towers(hidden):
    g = torch.Generator().manual_seed(1)
    model = ActorCritic(hidden, generator=g)
    torch.nn.init.normal_(model.actor_mean.weight, generator=g)
    torch.nn.init.normal_(model.critic_value.bias, generator=g)
    flat = model.flatten_()
    layout = cuda_acting_traj.kernel_layout(hidden)
    per_tower = 4 + 3 * MAX_HIDDEN + 1
    obs = torch.randn(16, 13, generator=g)
    with torch.no_grad():
        want = {4: model.actor(obs),
                1: model._tower("critic", model.critic_value, obs)}
    for t, n_head in enumerate((4, 1)):
        ints = layout[t * per_tower:(t + 1) * per_tower]
        src = ints[4 + 2 * MAX_HIDDEN:]
        assert int(ints[2]) % 4 == 0 and int(ints[1]) % 4 == 0
        sw, widths, offs, head_off = _stage_as_the_kernel_does(
            flat, ints, src, n_head)
        got = _tower_from_shared(sw, widths, offs, head_off, n_head, obs)
        torch.testing.assert_close(got, want[n_head], rtol=1e-5, atol=1e-6)
    ls_off = int(layout[2 * per_tower])
    torch.testing.assert_close(flat[ls_off:ls_off + 4], model.log_std.detach())


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
        cuda_acting_traj.kernel_layout((256, 256))


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
