"""The training slice as a whole: `ppo_cuda.make_train_step`, `train()`,
resume and `cli train`, on the CPU through the kernels' plain versions.

One whole train step is held to the reference's megakernel trainer in its
reference mode (`make_pallas_train_step(mode="reference",
fused_optimizer=True)`) on the same weights, the same env state and the
reference's own epoch permutations: params, optimizer state and metrics
within rtol 1e-4 / atol 1e-6 (torch and XLA round transcendentals and sums
differently, by a few ulp).
"""

import json
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import drone_tpu
from drone_tpu import ppo as jppo
from drone_tpu import ppo_pallas
from drone_tpu.models import ActorCritic as FlaxActorCritic
from drone_tpu_torch import cli, ppo_cuda, train
from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import (
    ActorCritic,
    fused_opt_state_from_flax,
    fused_opt_state_to_flax,
    params_from_flax,
)
from drone_tpu_torch.ops import ppo_update_cuda
from drone_tpu_torch.ppo import PPOConfig, init_runner
from drone_tpu_torch.utils.checkpoint import Checkpointer
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


def _tree_close(a, b, err):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-6, err_msg=err)


def test_train_step_matches_reference_trainer():
    hidden = (16, 16)
    jcfg = jppo.PPOConfig(**SMALL)
    jenv = drone_tpu.DroneEnv()
    fmodel = FlaxActorCritic(hidden=hidden)
    jr = jppo.init_runner(fmodel, jenv, jcfg, seed=1)
    jr = jr.replace(opt_state=ppo_pallas.init_fused_opt_state(jr.params))
    opt = jppo.make_optimizer(jcfg)
    jstep = jax.jit(ppo_pallas.make_pallas_train_step(
        opt, jenv.params, jenv.statics, jcfg, mode="reference",
        fused_optimizer=True))
    # the reference's epoch permutations (ppo_pallas.run_epoch_scans)
    _, kperm = jax.random.split(jr.key)
    n_rb = ppo_cuda.plan_minibatch_geometry(PPOConfig(**SMALL), 256)[3]
    perms = np.stack([np.asarray(jax.random.permutation(k, n_rb))
                      for k in jax.random.split(kperm, jcfg.epochs)])
    assert not (perms == np.arange(n_rb)).all()
    jr2, jm = jstep(jr)

    env = tenv.DroneEnv(device="cpu")
    model = ActorCritic(hidden)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr.params)))
    runner = init_runner(model, env, PPOConfig(**SMALL), seed=1)
    np.testing.assert_array_equal(runner.env_state.pos.numpy(),
                                  np.asarray(jr.env_state.pos))
    step = ppo_cuda.make_train_step(env, PPOConfig(**SMALL),
                                    permutations=lambda r: perms)
    r2, m = step(runner)

    assert set(m) == set(jm) == set(ppo_cuda.METRIC_KEYS)
    for k in jm:
        _tree_close(m[k], jm[k], k)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jr2.params))
    for name, t in r2.params.state_dict().items():
        _tree_close(t, want[name], name)
    count, mu, nu = fused_opt_state_to_flax(r2.opt_state, hidden)
    jcount, jmu, jnu = jr2.opt_state
    assert float(count) == float(jcount) == 4.0
    for i, (a, b) in enumerate(zip(mu + nu, list(jmu) + list(jnu))):
        assert a.shape == np.asarray(b).shape
        _tree_close(a, b, f"moment {i}")
    np.testing.assert_allclose(r2.env_state.fstate().numpy()[:, :3],
                               np.asarray(jr2.env_state.pos), rtol=1e-4,
                               atol=1e-5)
    assert r2.update_idx == int(jr2.update_idx) == 1


def test_fused_opt_state_converters_round_trip():
    params = FlaxActorCritic(hidden=(8, 4)).init(
        jax.random.PRNGKey(0), np.zeros((1, 13), np.float32))
    count, mu, nu = ppo_pallas.init_fused_opt_state(params)
    rng = np.random.default_rng(0)
    mu = [rng.normal(size=np.shape(t)).astype(np.float32) for t in mu]
    nu = [rng.uniform(size=np.shape(t)).astype(np.float32) for t in nu]
    state = fused_opt_state_from_flax((np.float32(7.0), mu, nu))
    assert state[1].shape == (sum(t.size for t in mu),)
    c2, mu2, nu2 = fused_opt_state_to_flax(state, (8, 4))
    assert float(c2) == 7.0
    for a, b in zip(mu + nu, mu2 + nu2):
        np.testing.assert_array_equal(a, b)


def _cfg(tmp_path, name, total, extra=()):
    cfg = Config.default().with_overrides([
        "train.num_envs=256", "train.horizon=8", "train.epochs=2",
        "train.num_minibatches=2", "run.hidden=16,16", "run.log_interval=1",
        "run.checkpoint_interval=100", f"run.total_updates={total}",
        f"run.run_name={name}", f"run.checkpoint_dir={tmp_path}", *extra])
    return cfg


def _runner_tensors(r):
    return ([*r.params.state_dict().values(), *r.opt_state,
             r.env_state.fstate(), r.env_state.step, r.env_state.reset_count,
             r.generator.get_state()])


def test_resume_is_bitwise(tmp_path):
    """train(4) == train(2) + resume(2), every tensor of the runner."""
    full, _ = train.train(_cfg(tmp_path, "full", 4), device="cpu")
    train.train(_cfg(tmp_path, "half", 2), device="cpu")
    ckpt = tmp_path / "half" / "checkpoints"
    resumed, last = train.train(
        _cfg(tmp_path, "resumed", 4, [f"run.resume_from={ckpt}"]),
        device="cpu")
    assert resumed.update_idx == full.update_idx == 4
    for a, b in zip(_runner_tensors(full), _runner_tensors(resumed)):
        assert torch.equal(a, b)
    assert np.isfinite(last["loss"])
    # a fresh run refuses a directory that holds another run's checkpoints
    with pytest.raises(RuntimeError, match="already contains"):
        train.train(_cfg(tmp_path, "half", 2), device="cpu")


def test_checkpointer_keeps_the_newest_three(tmp_path):
    cfg = _cfg(tmp_path, "keep", 5, ["run.checkpoint_interval=1",
                                      "run.log_interval=5"])
    train.train(cfg, device="cpu")
    ckpt = Checkpointer(tmp_path / "keep" / "checkpoints")
    assert ckpt.steps() == [3, 4, 5]
    raw, step = ckpt.restore_raw()
    assert step == 5 and set(raw) == {"params", "opt_state", "env_state",
                                      "generator", "noise_generator",
                                      "update_idx"}
    assert float(raw["opt_state"]["count"]) == 5 * 2 * 2


def test_cli_train_then_evaluate_on_cpu(tmp_path, capsys):
    rc = cli.main(["train", str(HOVER), "--device", "cpu",
                   "train.num_envs=256", "train.horizon=4",
                   "train.num_minibatches=2", "train.epochs=1",
                   "run.total_updates=2", "run.hidden=16,16",
                   f"run.checkpoint_dir={tmp_path}", "run.run_name=cli"])
    assert rc == 0
    lines = (tmp_path / "cli" / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["global_step"] == 2 * 256 * 4
    # evaluate restores the policy that train wrote
    cfg = Config.from_toml(HOVER).with_overrides([
        "run.hidden=16,16", f"run.resume_from={tmp_path}/cli/checkpoints",
        "env.params.horizon=30"])
    stats = train.evaluate(cfg, episodes=128, device="cpu")
    assert stats["episodes"] >= 128 and np.isfinite(stats["ep_return_mean"])
    capsys.readouterr()
    assert cli.main(["eval", str(HOVER), "--device", "cpu", "run.hidden=16,16",
                     f"run.resume_from={tmp_path}/cli/checkpoints",
                     "env.params.horizon=10"]) == 0


# run.rollout=scan trains on the scan trainer: test_torch_scan.py
# test_build_picks_the_trainer. bf16 training and run.profile_dir (the
# second item: what the option runs through) build on the megakernel
# trainer and train an update; the trace itself:
# test_profile_dir_writes_a_trace
@pytest.mark.parametrize("override,match", [
    ("run.compute_dtype=bfloat16", "bf16 training"),
    ("run.profile_dir=prof", "torch.profiler"),
])
def test_unported_training_options_name_their_roadmap_item(tmp_path,
                                                          override, match):
    del match
    cfg = _cfg(tmp_path, "x", 1, [override])
    env, model, runner, step, cfg = train.build(cfg, device="cpu")
    assert train.trainer_kind(cfg, model) == "megakernel"
    launches = ppo_update_cuda.bf16_launches
    runner, m = step(runner)
    assert runner.update_idx == 1 and np.isfinite(float(m["loss"]))
    assert ppo_update_cuda.bf16_launches == launches  # CPU: plain versions
    if cfg.run.compute_dtype == "bfloat16":
        assert model.dtype == torch.bfloat16


def test_profile_dir_writes_a_trace(tmp_path):
    """run.profile_dir traces updates 3 to 5 (the reference's start + 2 to
    start + 4) into <profile_dir>/trace/trace.json, a Chrome trace."""
    prof = tmp_path / "prof"
    train.train(_cfg(tmp_path, "p", 6, [f"run.profile_dir={prof}"]),
                device="cpu")
    events = json.loads((prof / "trace" / "trace.json").read_text())
    assert events["traceEvents"]
    # a run that ends inside the window writes its trace as it ends
    train.train(_cfg(tmp_path, "q", 3, [f"run.profile_dir={tmp_path}/q3"]),
                device="cpu")
    assert (tmp_path / "q3" / "trace" / "trace.json").exists()


def test_train_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train(_cfg(tmp_path, "gpu", 1))


def test_train_refuses_lanes_that_do_not_split(tmp_path):
    cfg = _cfg(tmp_path, "odd", 1, ["train.num_envs=384",
                                    "run.rollout=pallas"])
    with pytest.raises(ValueError, match="128"):
        train.build(cfg, device="cpu")
