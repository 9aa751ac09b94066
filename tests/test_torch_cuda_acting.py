"""K5, the MLP acting megakernel: its plain version against drone_tpu's.

`drone_tpu_torch.ops.act_rollout_cuda` runs its plain PyTorch version on CPU
tensors; it is held here to `drone_tpu.ops.act_rollout_pallas` in interpret
mode on the same weights, carried across by `params_from_flax`. The tower
is summed in another order (a matmul against the reference's W^T @ x) and
torch's tanh, log, sin and cos differ from XLA's by a few ulp, so short
horizons are held to rtol 2e-5 / atol 2e-6 (as tests/test_pallas_acting.py
holds the Pallas kernel to the scan path) and long ones statistically.

The kernel itself runs only on the card (chip_smoke.py). Its weight layout
is checked here: an emulation of csrc/acting.cu's tower, reading the packed
(big, small) fragments by the kernel's indices, must reproduce the
module's actor.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import drone_tpu
from drone_tpu.models import ActorCritic as FlaxActorCritic
from drone_tpu.ops import act_rollout_pallas
from drone_tpu_torch import env as tenv
from drone_tpu_torch import types as ttypes
from drone_tpu_torch.models import ActorCritic, params_from_flax
from drone_tpu_torch.ops import act_rollout_cuda, cuda_acting
from tests.helpers import pack_fstate_batch


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _policies(hidden, seed=0, log_std=0.0):
    """The same weights in both packages. The mean head is re-drawn at gain
    1.0 so actions are of order 1 and the comparison exercises the tower."""
    fmodel = FlaxActorCritic(hidden=hidden)
    params = fmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 13)))
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(p["actor_mean"]["kernel"].shape[0],
                                         4)))
    p["actor_mean"]["kernel"] = q.astype(np.float32)
    p["log_std"] = np.full(4, log_std, np.float32)
    tmodel = ActorCritic(hidden)
    tmodel.load_state_dict(params_from_flax({"params": p}))
    return {"params": p}, tmodel


@pytest.mark.parametrize("task,integrator,hidden,stochastic", [
    ("hover", "euler", (64, 64), False),
    ("hover", "euler", (64, 64), True),
    ("waypoint", "rk4", (32, 32, 32), False),
])
def test_plain_acting_matches_pallas_kernel_short_horizon(
        task, integrator, hidden, stochastic):
    N, T = 256, 3
    over = dict(horizon=2)  # every lane resets inside the window
    jp = drone_tpu.types.default_params(task, **over)
    jenv = drone_tpu.DroneEnv(task, integrator, params=jp)
    env = tenv.DroneEnv(task, integrator, ttypes.default_params(task, **over),
                        device="cpu")
    fparams, tmodel = _policies(hidden)
    j_final, j_stats = act_rollout_pallas(
        jenv.init_batch(2, N), fparams, jp, jenv.statics, T,
        lanes_per_block=N, interpret=True, stochastic=stochastic)
    launches = act_rollout_cuda.launches
    t_final, t_stats = act_rollout_cuda(env.init_batch(2, N), tmodel,
                                        env.params, env.statics, T,
                                        stochastic=stochastic)
    assert act_rollout_cuda.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(t_final.fstate().numpy(),
                               pack_fstate_batch(j_final),
                               rtol=2e-5, atol=2e-6)
    assert float(t_stats["episodes"]) == float(j_stats["episodes"]) >= N
    np.testing.assert_allclose(float(t_stats["reward_sum"]),
                               float(j_stats["reward_sum"]), rtol=1e-4)


def test_plain_acting_long_horizon_statistics():
    """Over many episodes the two implementations of one stochastic policy
    agree statistically though chaotic trajectories drift apart."""
    N, T = 256, 150
    jp = drone_tpu.types.default_params("hover", horizon=40)
    jenv = drone_tpu.DroneEnv(params=jp)
    env = tenv.DroneEnv(params=ttypes.default_params(horizon=40),
                        device="cpu")
    fparams, tmodel = _policies((64, 64), seed=3, log_std=-1.0)
    _, j_stats = act_rollout_pallas(jenv.init_batch(4, N), fparams, jp,
                                    jenv.statics, T, lanes_per_block=N,
                                    interpret=True, stochastic=True)
    _, t_stats = act_rollout_cuda(env.init_batch(4, N), tmodel, env.params,
                                  env.statics, T, stochastic=True)
    n_j, n_t = float(j_stats["episodes"]), float(t_stats["episodes"])
    assert n_j > 3 * N
    assert abs(n_t - n_j) / n_j < 0.02
    r_j = float(j_stats["reward_sum"]) / (N * T)
    r_t = float(t_stats["reward_sum"]) / (N * T)
    assert abs(r_t - r_j) < 0.01


def _tower_as_the_kernel_reads_it(weights, layout, obs):
    """csrc/acting.cu's tower: each layer's B = W^T gathered from its packed
    fragments by the kernel's index (float4 ((kt * NT + nt) * 32 + lane),
    lane = 4 g + t, component h of big for row k + 4 h, 2 + h of small),
    big + small, then the padded bias; the obs padded to 16 inputs."""
    lay = cuda_acting.act_layout(layout[5:5 + int(layout[0])])
    w = weights.double()

    def b_of(y):
        K, N = -(-y["nin"] // 8) * 8, -(-y["nout"] // 8) * 8
        frags = w[4 * y["fo"]:4 * y["fo"] + 2 * K * N].reshape(
            K // 8, N // 8, 32, 4)
        k, n = torch.arange(K)[:, None], torch.arange(N)[None, :]
        lane = 4 * (n % 8) + k % 4
        h = (k % 8) // 4
        return (frags[k // 8, n // 8, lane, h]
                + frags[k // 8, n // 8, lane, 2 + h])

    x = torch.nn.functional.pad(obs.double(), (0, 3))
    for i, y in enumerate(lay["layers"]):
        N = -(-y["nout"] // 8) * 8
        x = x @ b_of(y) + w[y["bo"]:y["bo"] + N]
        if i < len(lay["layers"]) - 1:
            x = torch.tanh(x)
    return x[:, :4].float()


@pytest.mark.parametrize("hidden", [(), (16,), (64, 64), (32, 32, 32),
                                    (20, 40, 8, 24)])
def test_packed_tower_layout(hidden):
    g = torch.Generator().manual_seed(0)
    model = ActorCritic(hidden, generator=g)
    torch.nn.init.normal_(model.actor_mean.weight, generator=g)
    torch.nn.init.normal_(model.actor_mean.bias, generator=g)
    weights, layout, std = cuda_acting.pack_tower_mma(model, "cpu")
    lay = cuda_acting.act_layout(hidden)
    assert weights.numel() == layout[4] == lay["wfl"] and layout[4] % 4 == 0
    assert layout[3] == lay["smem"] <= 232448 - 256
    obs = torch.randn(32, 13, generator=g)
    with torch.no_grad():
        want = model.actor(obs)
    got = _tower_as_the_kernel_reads_it(weights, layout, obs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(std, np.exp(np.zeros(4, np.float32)))


@pytest.mark.parametrize("hidden", [(8,) * 9, (300,), (256, 256)])
def test_pack_tower_refuses_what_the_kernel_cannot_take(hidden):
    with pytest.raises(ValueError):
        cuda_acting.pack_tower_mma(ActorCritic(hidden), "cpu")


def test_kernel_refuses_cpu_tensors():
    env = tenv.DroneEnv(device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_acting.act_rollout_kernel(env.init_batch(0, 8), ActorCritic(),
                                       env.params, env.statics, 2)
