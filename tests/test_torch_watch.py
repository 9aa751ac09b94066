"""`cli watch` and drone_tpu_torch.viewer: the rollout CSV of a checkpoint
and its render.

The CSV is held to the reference's dump_rollout (viz/viewer.py) on the same
weights, carried across by params_from_flax; the recurrent families' carry
to the evaluation path's (ppo_rnn.rollout_recurrent, which zeroes it where
an episode ends), cnn_lstm included, which the reference's `cli watch`
fails on.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone_tpu.models import ActorCritic as FlaxActorCritic
from drone_tpu.models import LSTMActorCritic as FlaxLSTM
from drone_tpu.train import build_env_and_model as jax_env_and_model
from drone_tpu.utils.config import Config as JaxConfig
from drone_tpu_torch import cli
from drone_tpu_torch.env import DroneEnv
from drone_tpu_torch.models import (
    ActorCritic,
    CNNLSTMActorCritic,
    LSTMActorCritic,
    params_from_flax,
)
from drone_tpu_torch.models.lstm import params_from_flax as lstm_from_flax
from drone_tpu_torch.ppo_rnn import rollout_recurrent
from drone_tpu_torch.types import default_params
from drone_tpu_torch.utils.checkpoint import Checkpointer
from drone_tpu_torch.utils.config import Config
from drone_tpu_torch.viewer import CSV_HEADER, dump_rollout, watch_rollout
from viz import viewer
from viz.viewer import dump_rollout as jax_dump_rollout
from viz.viewer import load_csv


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_cli_watch_renders_racing_with_gates(tmp_path, monkeypatch):
    """`cli watch` on racing: the CSV, a PNG, and the circuit's four gates
    handed to the render."""
    ckpt = tmp_path / "ckpt"
    Checkpointer(ckpt).save(0, ActorCritic((16,), generator=_gen()))
    drawn = []
    render = viewer.render

    def spy(rows, out_path, gates=None, **kw):
        drawn.append(gates)
        return render(rows, out_path, gates=gates, **kw)

    monkeypatch.setattr(viewer, "render", spy)
    out = tmp_path / "flight.png"
    rc = cli.main(["watch", "env.task=racing", "run.hidden=16",
                   f"run.resume_from={ckpt}", "--out", str(out),
                   "--steps", "40", "--device", "cpu"])
    assert rc == 0
    assert out.stat().st_size > 1000
    csv_path = tmp_path / "flight.csv"
    assert csv_path.read_text().startswith(CSV_HEADER)
    assert len(load_csv(csv_path)) == 40
    want = default_params("racing").gates.numpy()[:4]
    assert drawn == [[tuple(map(float, g)) for g in want]]


def test_dump_rollout_signals_episode_boundaries(tmp_path):
    """policy_fn sees the previous step's done flag, the CSV the step's."""
    env = DroneEnv("hover", params=default_params("hover", horizon=5),
                   device="cpu")
    dones_seen = []

    def policy(obs, done):
        assert obs.shape == (1, 13)
        dones_seen.append(int(done))
        return torch.zeros(4)  # motors off: fall, crash or truncate

    csv_path = tmp_path / "traj.csv"
    dump_rollout(env, env.params, policy, 12, str(csv_path), seed=0)
    done_col = [int(r["done"]) for r in load_csv(csv_path)]
    assert sum(done_col) >= 1
    assert dones_seen[0] == 0
    assert dones_seen[1:] == done_col[:-1]


@pytest.mark.parametrize("policy", ["lstm", "cnn_lstm"])
def test_cli_watch_recurrent_zeroes_carry(policy, tmp_path):
    """Both recurrent families render through the carry path, and their
    trajectory is the evaluation path's (its carry zeroed at every episode
    end) over several auto-resets."""
    model = (LSTMActorCritic(16, (16,), generator=_gen(1))
             if policy == "lstm" else CNNLSTMActorCritic(16, generator=_gen(1)))
    with torch.no_grad():
        model.log_std.fill_(-1.0)
    ckpt = tmp_path / "ckpt"
    Checkpointer(ckpt).save(0, model)
    common = [f"run.policy={policy}", "run.lstm_hidden=16", "run.hidden=16",
              f"run.resume_from={ckpt}", "env.params.horizon=6"]
    out = tmp_path / "rnn.png"
    steps = 20
    rc = cli.main(["watch", *common, "--out", str(out), "--steps",
                   str(steps), "--device", "cpu"])
    assert rc == 0
    assert out.stat().st_size > 1000
    rows = load_csv(tmp_path / "rnn.csv")
    assert sum(int(r["done"]) for r in rows) >= 2

    cfg = Config.default().with_overrides(common)
    statics, params = cfg.env.build()
    env = DroneEnv(statics.task, statics.integrator, params, device="cpu")
    model.eval()
    _, _, out_t = rollout_recurrent(model, env, env.init_batch(0, 1),
                                    model.initial_carry(1), steps)
    done = (out_t.terminated | out_t.truncated)[:, 0].numpy()
    assert [int(r["done"]) for r in rows] == done.astype(int).tolist()
    rel = np.array([[r["tx"] - r["x"], r["ty"] - r["y"], r["tz"] - r["z"]]
                    for r in rows])
    np.testing.assert_allclose(rel, out_t.obs[:, 0, :3].numpy(), atol=2e-4)
    np.testing.assert_allclose([r["reward"] for r in rows],
                               out_t.reward[:, 0].numpy(), atol=1e-4)


def _reference_policy(family, fparams, fmodel):
    """The reference `cli watch`'s policy_fn (drone_tpu/cli.py:138-153)."""
    if family == "mlp":
        fwd = jax.jit(lambda p, o: fmodel.apply(p, o[None])[0][0])
        return lambda obs, done: np.asarray(fwd(fparams, jnp.asarray(obs)))
    fwd = jax.jit(fmodel.apply)
    box = [fmodel.initial_carry((1,))]

    def policy_fn(obs, done):
        if done:
            box[0] = fmodel.initial_carry((1,))
        mean, _, _, c2 = fwd(fparams, jnp.asarray(obs)[None], box[0])
        box[0] = c2
        return np.asarray(mean[0])

    return policy_fn


@pytest.mark.parametrize("family", ["mlp", "lstm"])
def test_watch_csv_matches_reference(family, tmp_path):
    """The same weights through the reference's dump_rollout and the
    port's watch rollout: done equal and positions within 1e-3 over 40
    steps (several episodes of 15)."""
    overrides = ["env.params.horizon=15", "run.hidden=16,16",
                 "run.lstm_hidden=16", f"run.policy={family}"]
    key = jax.random.PRNGKey(3)
    if family == "mlp":
        fmodel = FlaxActorCritic(hidden=(16, 16))
        fparams = fmodel.init(key, jnp.zeros((1, 13)))
        state_dict = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                             fparams))
    else:
        fmodel = FlaxLSTM(hidden=16, encoder=(16,))
        fparams = fmodel.init(key, jnp.zeros((1, 13)),
                              fmodel.initial_carry((1,)))
        state_dict = lstm_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           fparams))
    ckpt = tmp_path / "ckpt"
    Checkpointer(ckpt).save(0, state_dict)
    cfg = Config.default().with_overrides(
        overrides + [f"run.resume_from={ckpt}"])
    ours = tmp_path / "ours.csv"
    assert watch_rollout(cfg, str(ours), 40, device="cpu") is None

    jenv, _ = jax_env_and_model(JaxConfig.default().with_overrides(overrides))
    theirs = tmp_path / "theirs.csv"
    jax_dump_rollout(jenv, jenv.params,
                     _reference_policy(family, fparams, fmodel), 40,
                     str(theirs), seed=0)
    a, b = load_csv(ours), load_csv(theirs)
    assert len(a) == len(b) == 40
    assert [r["done"] for r in a] == [r["done"] for r in b]
    assert sum(r["done"] for r in a) >= 2
    for k in ("x", "y", "z", "tx", "ty", "tz"):
        np.testing.assert_allclose([r[k] for r in a], [r[k] for r in b],
                                   atol=1e-3, err_msg=k)
    assert Path(ours).read_text().splitlines()[0] == \
        Path(theirs).read_text().splitlines()[0]
