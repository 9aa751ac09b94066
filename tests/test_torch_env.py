"""drone_tpu_torch.env against the C oracle and drone_tpu.env, bitwise.

The same inputs (seeds and action streams made with numpy) go through the
torch env, the batched C oracle and vmap(drone_tpu.env.step), for every
task x integrator pair, with domain randomization and auto-resets.
"""

import ctypes

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import drone_tpu
from drone_tpu import env as jenv
from drone_tpu_torch import env as tenv
from drone_tpu_torch import types as ttypes
from drone_tpu_torch.rollout import rollout_actions, rollout_actions_packed
from oracle import Oracle
from tests.helpers import action_stream, pack_fstate_batch

PAIRS = [(t, i) for t in ("hover", "waypoint", "racing")
         for i in ("euler", "rk4")]


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def overrides(task):
    """Short horizon (truncations), domain randomization on, and a wide
    reach radius so waypoint/gate progression fires."""
    over = dict(horizon=40, dr_mass_lo=0.8, dr_mass_hi=1.2,
                dr_thrust_lo=0.9, dr_thrust_hi=1.1)
    if task != "hover":
        over["reach_tol2"] = 4.0
    return over


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def istate(s) -> np.ndarray:
    """Torch state -> (N, 4) int32 in the oracle's istate order."""
    return torch.stack([s.step, s.reset_count, s.wp_count, s.gate_idx],
                       1).numpy()


@pytest.mark.parametrize("task,integrator", PAIRS)
def test_batched_step_bitwise_vs_oracle_and_jax(task, integrator):
    N, T = 64, 60
    over = overrides(task)
    jparams = drone_tpu.types.default_params(task, **over)
    o = Oracle(jparams, task=task, integrator=integrator)
    env = tenv.DroneEnv(task, integrator, ttypes.default_params(task, **over),
                        device="cpu")
    jenv_ = drone_tpu.DroneEnv(task, integrator, params=jparams)
    step_j = jax.jit(lambda s, a, p: jax.vmap(
        lambda x, y: jenv.step(x, y, p, jenv_.statics))(s, a))

    fs, ist, keys = o.reset_batch(7, N)
    s_t = env.init_batch(7, N)
    s_j = jenv_.init_batch(7, N)
    assert np.array_equal(bits(s_t.fstate()), bits(fs))
    acts = action_stream(T, n=N, seed=12, scale=0.9, bias=0.05)
    n_done = 0
    for t in range(T):
        obs_c, rew_c, term_c, trunc_c, ret_c, len_c = o.step_batch(
            fs, ist, acts[t], keys)
        s_t, out = env.step_batch(s_t, torch.from_numpy(acts[t]))
        s_j, out_j = step_j(s_j, jnp.asarray(acts[t]), jparams)
        assert np.array_equal(bits(s_t.fstate()), bits(fs)), f"t={t}"
        assert np.array_equal(istate(s_t), ist), f"t={t}"
        assert np.array_equal(bits(s_t.fstate()),
                              bits(pack_fstate_batch(s_j))), f"t={t}"
        assert np.array_equal(bits(out.obs), bits(obs_c))
        assert np.array_equal(bits(out.reward), bits(rew_c))
        assert np.array_equal(bits(out.reward), bits(out_j.reward))
        assert np.array_equal(out.terminated.numpy(), term_c)
        assert np.array_equal(out.truncated.numpy(), trunc_c)
        assert np.array_equal(bits(out.ep_return), bits(ret_c))
        assert np.array_equal(out.ep_length.numpy(), len_c)
        n_done += int((out.terminated | out.truncated).sum())
    assert n_done > N  # every lane reset at least once
    if task != "hover":
        assert int(s_t.wp_count.sum()) > 0


def test_reset_across_episodes_vs_oracle():
    env = tenv.DroneEnv("waypoint", device="cpu")
    o = Oracle(drone_tpu.types.default_params("waypoint"), task="waypoint")
    k0, k1 = o.lane_key(42, 0)
    for episode in (0, 1, 77, 2**31, 2**32 - 1):
        fs = np.zeros(19, np.float32)
        ist = np.zeros(4, np.int32)
        o.lib.drone_reset(fs, ist, ctypes.byref(o.cparams), k0, k1, episode,
                          o.task)
        s = tenv.reset_state(torch.tensor([k0]), torch.tensor([k1]), episode,
                             env.params, env.statics)
        assert np.array_equal(bits(s.fstate()[0]), bits(fs)), episode
        assert int(s.reset_count[0]) & 0xFFFFFFFF == episode


def test_long_trajectory_bitwise_vs_oracle():
    """2,000 steps of one hover lane: every state, obs, reward and flag."""
    env = tenv.DroneEnv(device="cpu")
    o = Oracle(drone_tpu.types.default_params("hover"))
    T = 2000
    acts = action_stream(T, seed=42)
    fs, ist, keys = o.reset(42, 0)
    golden = o.rollout(fs, ist, acts, keys)
    _, (out, packed) = rollout_actions_packed(
        env.init_batch(42, 1), torch.from_numpy(acts)[:, None], env.params,
        env.statics)
    assert np.array_equal(bits(packed[:, 0]), bits(golden["fstate"]))
    assert np.array_equal(bits(out.obs[:, 0]), bits(golden["obs"]))
    assert np.array_equal(bits(out.reward[:, 0]), bits(golden["reward"]))
    assert np.array_equal(out.terminated[:, 0].numpy(),
                          golden["terminated"].astype(bool))
    assert np.array_equal(out.ep_length[:, 0].numpy(), golden["ep_length"])
    assert golden["terminated"].sum() + golden["truncated"].sum() > 0
    _, out2 = rollout_actions(env.init_batch(42, 1),
                              torch.from_numpy(acts[:300])[:, None],
                              env.params, env.statics)
    assert np.array_equal(bits(out2.obs), bits(out.obs[:300]))


def test_params_live_on_the_state_device():
    """Env params are tensors on the env's device, never Python floats: on
    CUDA torch divides by a CPU scalar through its reciprocal."""
    env = tenv.DroneEnv(device="cpu")
    for name, value in vars(env.params).items():
        assert isinstance(value, torch.Tensor), name
        assert value.device == env.device, name
    assert env.params.horizon.dtype == torch.int32
    assert env.params.mass.dtype == torch.float32


def test_default_params_match_jax():
    for task in ("hover", "waypoint", "racing"):
        jp = drone_tpu.types.default_params(task)
        tp = ttypes.default_params(task)
        for name, value in vars(tp).items():
            want = np.asarray(getattr(jp, name))
            assert want.dtype == value.numpy().dtype, name
            assert np.array_equal(want, value.numpy()), name


def test_device_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tenv.DroneEnv()
