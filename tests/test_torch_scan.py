"""The scan trainer (`ppo.make_train_step`): autograd PPO over the policy
module with K4 as its optimizer, on the CPU through K4's plain version.

One whole scan update is held to the reference's scan trainer
(`drone_tpu.ppo.make_train_step(rollout="scan")`) on the same weights, the
same env state and the reference's own draws (its rollout noise and epoch
permutations, recomputed here from its key splits and fed through `noise=`
and `permutations=`): params, optimizer moments and metrics within rtol
1e-4 / atol 1e-6, as the megakernel trainer is in test_torch_train.py.
Also: build()'s choice of trainer, resume across trainers, and K4 past
524,288 parameters against a float64 evaluation of the optax chain.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import drone_tpu
from drone_tpu import ppo as jppo
from drone_tpu import ppo_pallas
from drone_tpu.models import ActorCritic as FlaxActorCritic
from drone_tpu_torch import ppo, ppo_cnn_cuda, ppo_cuda, ppo_rnn, ppo_rnn_cuda
from drone_tpu_torch import env as tenv
from drone_tpu_torch import train
from drone_tpu_torch.models import (
    ActorCritic,
    fused_opt_state_from_flax,
    params_from_flax,
)
from drone_tpu_torch.ops import cuda_update
from drone_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
HOVER = ROOT / "configs" / "hover.toml"
SMALL = dict(horizon=8, num_envs=256, epochs=2, num_minibatches=2,
             anneal_lr=True, total_updates=10)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, err):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-6, err_msg=err)


def reference_draws(key, cfg, n_perm):
    """The reference scan trainer's rollout noise (T, N, 4) and epoch
    permutations (epochs, n_perm) for a runner key (drone_tpu/ppo.py
    train_step's splits)."""
    _, krollout, kperm = jax.random.split(key, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (cfg.num_envs, 4),
                                                   jnp.float32))
                      for k in jax.random.split(krollout, cfg.horizon)])
    perms = np.stack([np.asarray(jax.random.permutation(k, n_perm))
                      for k in jax.random.split(kperm, cfg.epochs)])
    return noise, perms


@pytest.fixture(scope="module")
def reference():
    """The reference's env, model and runner from seed 1 (its init_runner,
    compiled once)."""
    jenv = drone_tpu.DroneEnv()
    fmodel = FlaxActorCritic(hidden=(16, 16))
    jcfg = jppo.PPOConfig(**SMALL)
    return jenv, fmodel, jax.jit(
        lambda: jppo.init_runner(fmodel, jenv, jcfg, seed=1))()


@pytest.mark.parametrize("shuffle", ["lanes", "flat"])
def test_scan_update_matches_reference(reference, shuffle):
    hidden = (16, 16)
    jcfg = jppo.PPOConfig(shuffle=shuffle, **SMALL)
    jenv, fmodel, jr = reference
    jstep = jax.jit(jppo.make_train_step(
        fmodel.apply, jppo.make_optimizer(jcfg), jenv.params, jenv.statics,
        jcfg, rollout="scan"))
    n_perm = jcfg.num_envs * (1 if shuffle == "lanes" else jcfg.horizon)
    noise, perms = reference_draws(jr.key, jcfg, n_perm)
    jr2, jm = jstep(jr)

    cfg = ppo.PPOConfig(shuffle=shuffle, **SMALL)
    env = tenv.DroneEnv(device="cpu")
    model = ActorCritic(hidden)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr.params)))
    runner = ppo.init_runner(model, env, cfg, seed=1)
    step = ppo.make_train_step(model, env, cfg,
                               permutations=lambda r: perms,
                               noise=lambda r: torch.from_numpy(noise))
    r2, m = step(runner)

    assert set(m) == set(jm) == set(ppo.METRIC_KEYS)
    for k in jm:
        _close(m[k], jm[k], k)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jr2.params))
    for name, t in r2.params.state_dict().items():
        _close(t, want[name], name)
    jcount, jmu, jnu = fused_opt_state_from_flax(
        ppo_pallas.optax_to_fused_opt_state(jr2.opt_state))
    count, mu, nu = r2.opt_state
    assert float(count) == float(jcount) == 4.0
    _close(mu, jmu, "mu")
    _close(nu, jnu, "nu")
    assert r2.update_idx == int(jr2.update_idx) == 1


def test_scan_update_draws_from_the_runner_generators():
    """Without replayed draws the noise comes from the runner's noise
    generator and the permutations from its CPU generator: two runners
    from one seed step identically, and the generators advance."""
    cfg = ppo.PPOConfig(**SMALL)
    env = tenv.DroneEnv(device="cpu")
    outs = []
    for _ in range(2):
        model = ActorCritic((8,), generator=torch.Generator().manual_seed(3))
        runner = ppo.init_runner(model, env, cfg, seed=3)
        g0 = runner.noise_generator.get_state().clone()
        r2, m = ppo.make_train_step(model, env, cfg)(runner)
        assert not torch.equal(r2.noise_generator.get_state(), g0)
        outs.append((r2.params.flat.clone(), m["loss"]))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _cfg(tmp_path, name, total, extra=()):
    return Config.default().with_overrides([
        "train.num_envs=256", "train.horizon=8", "train.epochs=2",
        "train.num_minibatches=2", "run.hidden=16,16", "run.log_interval=1",
        "run.checkpoint_interval=100", "run.lstm_hidden=16",
        f"run.total_updates={total}", f"run.run_name={name}",
        f"run.checkpoint_dir={tmp_path}", *extra])


# build()'s choice of trainer (the reference's drone_tpu/train.py build, the
# port's own envelope checks): (overrides, trainer, the step's module)
MLP, CNN = (), ("run.policy=cnn",)
LSTM, CNN_LSTM = ("run.policy=lstm", "train.bptt_horizon=4"), \
    ("run.policy=cnn_lstm", "train.bptt_horizon=4")
BUILD_CASES = [
    (MLP, "megakernel", ppo_cuda),
    ((*MLP, "run.rollout=scan"), "scan", ppo),
    ((*MLP, "train.num_envs=384"), "scan", ppo),
    ((*MLP, "run.hidden=256,256"), "scan", ppo),
    ((*MLP, "run.hidden=32,32,32,32,32,32,32,32,32"), "scan", ppo),
    (CNN, "megakernel", ppo_cnn_cuda),
    ((*CNN, "run.rollout=scan"), "scan", ppo),
    ((*CNN, "train.num_envs=384"), "scan", ppo),
    (("run.policy=cnn_overlap",), "scan", ppo),
    (LSTM, "megakernel", ppo_rnn_cuda),
    ((*LSTM, "run.rollout=scan"), "scan", ppo_rnn),
    ((*LSTM, "train.num_envs=384"), "hybrid", ppo_rnn),
    ((*LSTM, "train.num_envs=384", "run.rollout=pallas"), "hybrid", ppo_rnn),
    ((*LSTM, "run.lstm_hidden=256"), "scan", ppo_rnn),
    (CNN_LSTM, "megakernel", ppo_rnn_cuda),
    ((*CNN_LSTM, "train.num_envs=384"), "hybrid", ppo_rnn),
    ((*CNN_LSTM, "run.rollout=scan"), "scan", ppo_rnn),
]


@pytest.mark.parametrize("over,kind,module", BUILD_CASES,
                         ids=[" ".join(c[0]) or "mlp" for c in BUILD_CASES])
def test_build_picks_the_trainer(tmp_path, over, kind, module):
    cfg = _cfg(tmp_path, "x", 1, over)
    _, model = train.build_env_and_model(cfg, device="cpu")
    assert train.trainer_kind(cfg, model) == kind
    _, _, runner, step, _ = train.build(cfg, device="cpu")
    assert step.__module__ == module.__name__
    assert runner.noise_generator is not None


@pytest.mark.parametrize("over,match", [
    (("run.rollout=pallas", "train.num_envs=384"), "128"),
    (("run.rollout=pallas", "run.hidden=256,256"), "megakernel"),
    (("run.rollout=pallas", "run.policy=cnn_overlap"), "cnn_overlap"),
    (("run.rollout=pallas", "run.policy=lstm", "run.lstm_hidden=256",
      "train.bptt_horizon=4"), "hybrid"),
])
def test_build_refuses_pallas_where_no_kernel_tier_takes_the_run(
        tmp_path, over, match):
    with pytest.raises(ValueError, match=match):
        train.build(_cfg(tmp_path, "x", 1, over), device="cpu")


@pytest.mark.parametrize("first,then", [("pallas", "scan"),
                                        ("scan", "pallas")])
def test_checkpoint_resumes_under_the_other_trainer(tmp_path, first, then):
    """One optimizer state for both trainers: a checkpoint of either
    resumes under the other with the moments and the count as saved
    (bitwise), and training goes on from them."""
    saved, _ = train.train(_cfg(tmp_path, "a", 2,
                                [f"run.rollout={first}"]), device="cpu")
    ckpt = tmp_path / "a" / "checkpoints"
    cfg = _cfg(tmp_path, "b", 2, [f"run.rollout={then}",
                                  f"run.resume_from={ckpt}"])
    _, _, template, step, cfg = train.build(cfg, device="cpu")
    from drone_tpu_torch.utils.checkpoint import Checkpointer

    restored, at = Checkpointer(ckpt).restore(template)
    assert at == 2
    for a, b in zip(restored.opt_state, saved.opt_state):
        assert torch.equal(a, b)
    assert torch.equal(restored.params.flat, saved.params.flat)
    assert float(restored.opt_state[0]) == 2 * 2 * 2
    resumed, last = train.train(_cfg(tmp_path, "c", 3, [
        f"run.rollout={then}", f"run.resume_from={ckpt}"]), device="cpu")
    assert float(resumed.opt_state[0]) == 3 * 2 * 2
    assert np.isfinite(last["loss"])


def test_k4_plain_past_the_one_slice_envelope_matches_optax_in_float64():
    """K4's plain version at P = 600,000 (past 256 slices of 2,048, where
    the kernel's blocks own several slices each) against a float64
    evaluation of clip_by_global_norm + adam at step count 5, the clip
    active and inactive."""
    P = 600_000
    assert cuda_update.adam_blocks(P) == cuda_update.ADAM_MAX_BLOCKS
    assert len(cuda_update.adam_slices(P)) == 293
    rng = np.random.default_rng(0)
    theta0 = rng.normal(size=P).astype(np.float32)
    mu0 = (0.01 * rng.normal(size=P)).astype(np.float32)
    nu0 = (0.001 * rng.uniform(size=P)).astype(np.float32)
    cfg = ppo.PPOConfig(anneal_lr=True, total_updates=10)
    ac, sched = ppo.make_optimizer(cfg)
    sizes = [P - 100_000, 100_000]
    for scale in (1e-3, 1e-6):  # |g| ~ 0.77 (clipped) and ~0.0008
        g = (scale * rng.normal(size=P)).astype(np.float32)
        th, mu, nu = (torch.from_numpy(x.copy()) for x in (theta0, mu0, nu0))
        count = torch.tensor(5.0)
        cuda_update.fused_adam_plain(th, torch.from_numpy(g), mu, nu, count,
                                     ac, sched, sizes)
        gd = g.astype(np.float64)
        gn = np.sqrt(np.sum(gd * gd))
        gd = gd * (ac.clip_norm / gn if gn > ac.clip_norm else 1.0)
        lr = cfg.lr * (1.0 - 5.0 / sched.total_steps)
        m = ac.b1 * mu0 + (1 - ac.b1) * gd
        v = ac.b2 * nu0 + (1 - ac.b2) * gd * gd
        upd = -lr * (m / (1 - ac.b1 ** 6)) / (
            np.sqrt(v / (1 - ac.b2 ** 6)) + ac.eps)
        np.testing.assert_allclose(mu.numpy(), m, rtol=1e-5, atol=1e-9)
        np.testing.assert_allclose(nu.numpy(), v, rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(th.numpy(), theta0 + upd, rtol=1e-5,
                                   atol=1e-7)
        assert float(count) == 6.0
