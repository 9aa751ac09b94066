"""The slice as a whole: drone_tpu_torch.train.evaluate and `cli eval`.

evaluate() on the CPU runs the plain versions of the kernels; it is held
to drone_tpu.train.evaluate on the same converted weights. The package's
import rule (no JAX, no drone_tpu, no oracle) is checked by walking its
syntax trees.
"""

import ast
import dataclasses
import json
import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from drone_tpu import train as jtrain
from drone_tpu.models import ActorCritic as FlaxActorCritic
from drone_tpu.utils.config import Config as JaxConfig
from drone_tpu_torch import cli, train
from drone_tpu_torch.models import ActorCritic, params_from_flax
from drone_tpu_torch.ops import act_rollout_cuda
from drone_tpu_torch.utils.checkpoint import Checkpointer
from drone_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
HOVER = ROOT / "configs" / "hover.toml"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "drone_tpu", "oracle",
             "tests")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted((ROOT / "drone_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _weights(hidden, seed=0):
    fmodel = FlaxActorCritic(hidden=hidden)
    params = fmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, 13)))
    return params, params_from_flax(jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("episodes", [128, 64])
def test_evaluate_matches_jax(episodes):
    """128 episodes take the acting kernels in both packages (the plain
    version here, interpret-mode Pallas there); at 64 the reference takes
    its scan path while the port still takes K5's plain version."""
    overrides = ["env.params.horizon=60", "run.hidden=16,16"]
    jcfg = JaxConfig.from_toml(HOVER).with_overrides(overrides)
    cfg = Config.from_toml(HOVER).with_overrides(overrides)
    fparams, state_dict = _weights((16, 16))
    want = jtrain.evaluate(jcfg, runner=types.SimpleNamespace(params=fparams),
                           episodes=episodes)
    launches = act_rollout_cuda.launches
    got = train.evaluate(cfg, runner=types.SimpleNamespace(params=state_dict),
                         episodes=episodes, device="cpu")
    assert act_rollout_cuda.launches == launches
    assert got["episodes"] == want["episodes"] >= episodes
    for key in ("ep_return_mean", "ep_length_mean"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    np.testing.assert_allclose(got["ep_return_std"], want["ep_return_std"],
                               rtol=1e-3)


def test_stochastic_evaluate_goes_through_rollout_policy():
    cfg = Config.from_toml(HOVER).with_overrides(["env.params.horizon=30"])
    model = ActorCritic((64, 64), generator=torch.Generator().manual_seed(0))
    launches = act_rollout_cuda.launches
    stats = train.evaluate(cfg, runner=types.SimpleNamespace(params=model),
                           episodes=32, deterministic=False, device="cpu")
    assert act_rollout_cuda.launches == launches
    assert stats["episodes"] >= 32
    assert np.isfinite(stats["ep_return_mean"]) and stats["ep_return_std"] >= 0
    assert 1.0 <= stats["ep_length_mean"] <= 31.0


def test_cli_eval_on_cpu(tmp_path, capsys):
    model = ActorCritic((64, 64), generator=torch.Generator().manual_seed(1))
    Checkpointer(tmp_path).save(3, model)
    rc = cli.main(["eval", str(HOVER), "--device", "cpu",
                   f"run.resume_from={tmp_path}", "env.params.horizon=20"])
    assert rc == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats["episodes"] >= 64
    assert set(stats) == {"episodes", "ep_return_mean", "ep_return_std",
                          "ep_length_mean"}


def test_evaluate_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.evaluate(Config.from_toml(HOVER))


@pytest.mark.parametrize("name", ["hover", "waypoint", "racing",
                                  "sweep_hover"])
def test_configs_load_as_in_the_reference(name):
    path = ROOT / "configs" / f"{name}.toml"
    want, got = JaxConfig.from_toml(path), Config.from_toml(path)
    assert dataclasses.asdict(got.run) == dataclasses.asdict(want.run)
    assert dataclasses.asdict(got.train) == dataclasses.asdict(want.train)
    assert got.env.task == want.env.task
    assert got.env.integrator == want.env.integrator
    assert got.env.params == want.env.params
    assert got.sweep == want.sweep


def test_checkpointer_round_trip_and_missing_dir(tmp_path):
    model = ActorCritic((16,), generator=torch.Generator().manual_seed(2))
    ckpt = Checkpointer(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_raw()
    ckpt.save(1, model)
    ckpt.save(10, model.state_dict())
    raw, step = ckpt.restore_raw()
    assert step == 10
    for name, t in model.state_dict().items():
        assert torch.equal(raw["params"][name], t), name
    assert not (tmp_path / "missing").exists()
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "missing").restore_raw()
    assert not (tmp_path / "missing").exists()
