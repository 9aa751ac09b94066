"""drone_tpu_torch.autotune: candidate shapes (held to drone_tpu.autotune's
lists on its CPU backend), the ranking, the per-candidate catch, and one
real measurement through train.build on the CPU.
"""

import dataclasses
from pathlib import Path

import jax
import pytest
import torch

from drone_tpu import autotune as jautotune
from drone_tpu.utils.config import Config as JaxConfig
from drone_tpu_torch import autotune as tautotune
from drone_tpu_torch.autotune import (
    autotune,
    candidate_shapes,
    measure_train_sps,
)
from drone_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(num_envs=512, mb=2, horizon=8):
    cfg = Config.default()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_envs=num_envs, num_minibatches=mb, horizon=horizon,
        epochs=1))
    cfg.run.total_updates = 4
    return cfg


def test_candidate_shapes_alignment_and_baseline():
    cfg = _cfg(num_envs=4096, mb=4)
    cands = candidate_shapes(cfg)
    assert (4096, 4) in cands  # the current config is always measured
    for n, mb in cands:
        assert n % (128 * mb) == 0 or (n, mb) == (4096, 4), (n, mb)
    assert len({n for n, _ in cands}) >= 3
    assert len({mb for _, mb in cands}) >= 2


@pytest.mark.parametrize("mesh", [True, False])
@pytest.mark.parametrize("case", ["hover", "sweep_hover", "misaligned",
                                  "small"])
def test_candidate_shapes_match_reference(case, mesh, monkeypatch):
    """The port's list is the reference's on its CPU backend (its 128-lane
    rule), with the port's world the reference's device count (8 virtual
    CPU devices here) when run.mesh shards."""
    overrides = [f"run.mesh={str(mesh).lower()}"]
    if case in ("hover", "sweep_hover"):
        path = ROOT / "configs" / f"{case}.toml"
        jcfg = JaxConfig.from_toml(path).with_overrides(overrides)
        cfg = Config.from_toml(path).with_overrides(overrides)
    else:
        n, mb = (384, 3) if case == "misaligned" else (96, 2)
        shape = [f"train.num_envs={n}", f"train.num_minibatches={mb}"]
        jcfg = JaxConfig.default().with_overrides(overrides + shape)
        cfg = Config.default().with_overrides(overrides + shape)
    assert jax.default_backend() == "cpu"
    monkeypatch.setattr(tautotune, "world_size", lambda: len(jax.devices()))
    want = jautotune.candidate_shapes(jcfg)
    assert candidate_shapes(cfg) == want
    assert want[0] == (cfg.train.num_envs, cfg.train.num_minibatches)


def test_candidate_shapes_keeps_misaligned_baseline():
    cands = candidate_shapes(_cfg(num_envs=384, mb=3))
    assert (384, 3) in cands
    cands = candidate_shapes(_cfg(num_envs=96, mb=2))
    assert cands.count((96, 2)) == 1


def test_autotune_ranks_with_stub_measure():
    def fake(c):
        return (float(c.train.num_envs * 10 - c.train.num_minibatches),
                "stub")

    res = autotune(_cfg(), candidates=[(256, 2), (1024, 2), (512, 4)],
                   measure_fn=fake, verbose=False)
    assert [r["num_envs"] for r in res] == [1024, 512, 256]
    assert res[0]["overrides"] == "train.num_envs=1024 train.num_minibatches=2"
    assert all(r["trainer"] == "stub" for r in res)


def test_autotune_skips_failing_candidates(capsys):
    def flaky(c):
        if c.train.num_envs == 512:
            raise RuntimeError("out of memory (simulated)")
        return 1.0, "stub"

    res = autotune(_cfg(), candidates=[(256, 2), (512, 2)], measure_fn=flaky)
    assert [r["num_envs"] for r in res] == [256]
    assert "num_envs=512 num_minibatches=2: failed" in capsys.readouterr().out


@pytest.mark.parametrize("shape, label", [((256, 2), "megakernel"),
                                          ((96, 2), "scan/hybrid")])
def test_autotune_real_measurement_tiny(shape, label):
    """One real candidate through train.build and the timed loop on the
    CPU: the megakernel trainer where its 128-lane rows split, the scan
    trainer otherwise."""
    sps, got = measure_train_sps(_cfg(*shape, horizon=8), iters=1,
                                 device="cpu")
    assert sps > 0
    assert got == label


def test_measure_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_train_sps(_cfg(), iters=1)
