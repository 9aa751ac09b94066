"""drone_tpu_torch.sweep: the GP-EI suggester, the Pareto front, successive
halving with its journal and resume, the spawned trial launcher, and one
real sweep through train.train on the CPU.

The engine's cases are tests/test_sweep.py's, run against the port; the
suggester's points and the Pareto front are held to drone_tpu.sweep's,
bit for bit, on the same observations.
"""

import json
import math
import random

import numpy as np
import pytest
import torch

from drone_tpu import sweep as jsweep
from drone_tpu_torch.sweep import (
    GPSuggester,
    pareto_front,
    run_sweep,
    sample_point,
)
from drone_tpu_torch.utils.config import Config

SPACE = {
    "train.lr": {"log": [1e-5, 1e-1]},
    "train.clip_eps": {"lin": [0.0, 1.0]},
}


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _objective(point):
    """Smooth bowl with the optimum at lr=1e-3, clip=0.3 (maximized)."""
    u = (math.log10(point["train.lr"]) + 3.0) / 2.0   # 0 at optimum, +-2
    v = (point["train.clip_eps"] - 0.3) / 0.35
    return -(u * u + v * v)


def test_gp_suggester_beats_random_search():
    """Equal budget (24 trials), same seed: the GP's best found value must
    beat random search's on the bowl."""
    budget = 24

    def best_with(sug, seed):
        rng = random.Random(seed)
        best = -np.inf
        for _ in range(budget):
            p = sug.suggest() if sug else sample_point(SPACE, rng)
            s = _objective(p)
            if sug:
                sug.observe(p, s)
            best = max(best, s)
        return best

    wins = 0
    for seed in (0, 1, 2):
        b_gp = best_with(GPSuggester(SPACE, seed=seed), seed)
        b_rand = best_with(None, seed)
        wins += b_gp > b_rand
        assert b_gp > -0.15, (seed, b_gp)
    assert wins >= 2


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cost_aware", [False, True])
def test_gp_suggester_matches_reference_bitwise(seed, cost_aware):
    """Same seed, same observations (scores and costs, a failure among
    them): every suggested point equals the reference's bit for bit."""
    space = dict(SPACE)
    space["train.num_minibatches"] = {"choice": [2, 4, 8]}
    ours = GPSuggester(space, seed=seed, cost_aware=cost_aware)
    ref = jsweep.GPSuggester(space, seed=seed, cost_aware=cost_aware)
    for k in range(16):
        p, q = ours.suggest(), ref.suggest()
        assert p == q, (k, p, q)
        score = (float("nan") if k == 5
                 else _objective(p) - 0.01 * p["train.num_minibatches"])
        cost = 1.0 + p["train.clip_eps"] * 3.0
        ours.observe(p, score, cost=cost)
        ref.observe(q, score, cost=cost)
    assert ours.y == ref.y
    np.testing.assert_array_equal(np.stack(ours.X), np.stack(ref.X))


def test_pareto_front_matches_reference():
    rng = random.Random(4)
    rs = [{"cost": rng.choice([1, 2, 3, 5, 8]),
           "score": round(rng.uniform(-1.0, 1.0), 1), "i": i}
          for i in range(40)]
    assert pareto_front(rs) == jsweep.pareto_front(rs)
    assert pareto_front(rs)


def test_gp_suggester_api_roundtrip():
    sug = GPSuggester(SPACE, seed=3, n_init=2)
    for _ in range(6):
        p = sug.suggest()
        assert 1e-5 <= p["train.lr"] <= 1e-1
        assert 0.0 <= p["train.clip_eps"] <= 1.0
        sug.observe(p, _objective(p))
    u = sug._encode(p)
    p2 = sug._decode(u)
    assert abs(math.log(p2["train.lr"]) - math.log(p["train.lr"])) < 1e-9
    # NaN/-inf observations don't poison the surrogate
    sug.observe(sug.suggest(), float("nan"))
    sug.observe(sug.suggest(), float("-inf"))
    assert all(math.isfinite(y) for y in sug.y)
    assert np.isfinite(sug._encode(sug.suggest())).all()


def test_gp_suggester_categorical():
    space = dict(SPACE)
    space["train.num_minibatches"] = {"choice": [2, 4, 8]}
    sug = GPSuggester(space, seed=0, n_init=2)
    for _ in range(8):
        p = sug.suggest()
        assert p["train.num_minibatches"] in (2, 4, 8)
        sug.observe(p, _objective(p) - 0.1 * p["train.num_minibatches"])


def test_pareto_front():
    rs = [
        {"cost": 1, "score": 0.5},   # front (cheapest)
        {"cost": 2, "score": 0.4},   # dominated by the first
        {"cost": 2, "score": 0.9},   # front
        {"cost": 5, "score": 0.9},   # dominated (same score, pricier)
        {"cost": 5, "score": 1.2},   # front (best score)
    ]
    front = pareto_front(rs)
    assert [r["cost"] for r in front] == [1, 2, 5]
    assert [r["score"] for r in front] == [0.5, 0.9, 1.2]


def _fake_train(cfg):
    """Module-level (picklable) trial: deterministic score from the point."""
    return {"score": _objective({
        "train.lr": cfg.train.lr,
        "train.clip_eps": cfg.train.clip_eps,
    })}


def test_run_sweep_parallel_workers(tmp_path):
    """workers=2: the trials of a batch run in spawned processes and give
    the sequential run's records."""
    cfg = Config.default()
    cfg.run.checkpoint_dir = str(tmp_path)
    cfg.sweep = {"metric": "score", "trials": 4, "rungs": [1], "keep": 0.5,
                 "space": SPACE, "suggester": "random", "workers": 2}
    results = run_sweep(cfg, train_fn=_fake_train)
    assert len(results) == 4
    assert all(math.isfinite(r["score"]) for r in results)
    assert results[0]["score"] == max(r["score"] for r in results)
    cfg.sweep["workers"] = 1
    assert run_sweep(cfg, train_fn=_fake_train) == results


def test_cost_aware_acquisition_prefers_cheap_region():
    """gp_pareto: with a flat objective and observed costs 10x higher in
    one half of the space, suggestions concentrate in the cheap half."""
    rng = random.Random(0)
    sug = GPSuggester(SPACE, seed=0, n_init=2, cost_aware=True)
    for _ in range(12):
        p = sample_point(SPACE, rng)
        cost = 10.0 if p["train.clip_eps"] > 0.5 else 1.0
        sug.observe(p, 0.0, cost=cost)
    cheap = sum(sug.suggest()["train.clip_eps"] <= 0.5 for _ in range(10))
    assert cheap >= 8, cheap
    base = GPSuggester(SPACE, seed=0, n_init=2, cost_aware=False)
    rng = random.Random(0)
    for _ in range(12):
        p = sample_point(SPACE, rng)
        base.observe(p, 0.0)
    cheap_base = sum(base.suggest()["train.clip_eps"] <= 0.5
                     for _ in range(10))
    assert cheap_base < cheap


def test_failure_penalty_does_not_ratchet():
    sug = GPSuggester(SPACE, seed=1, n_init=2)
    sug.observe(sample_point(SPACE, random.Random(1)), -2.0)
    for _ in range(4):
        sug.observe(sample_point(SPACE, random.Random(2)), float("nan"))
    assert sug.y[1:] == [-3.0, -3.0, -3.0, -3.0]


def test_diverged_trial_does_not_abort_sweep(tmp_path):
    cfg = Config.default()
    cfg.run.checkpoint_dir = str(tmp_path)
    cfg.sweep = {"metric": "score", "trials": 4, "rungs": [1],
                 "keep": 0.5, "space": SPACE, "suggester": "random"}
    out = tmp_path / "results.json"
    n = []

    def flaky(c):
        n.append(1)
        if len(n) == 2:
            raise RuntimeError("diverged")
        return _fake_train(c)

    results = run_sweep(cfg, out_path=out, train_fn=flaky)
    assert len(results) == 4
    assert sum(r["score"] == float("-inf") for r in results) == 1
    assert sum(math.isfinite(r["score"]) for r in results) == 3
    journal = tmp_path / "results.json.jsonl"
    assert len(journal.read_text().splitlines()) == 4


def test_sweep_journal_and_resume(tmp_path):
    cfg = Config.default()
    cfg.run.checkpoint_dir = str(tmp_path)
    cfg.sweep = {"metric": "score", "trials": 6, "rungs": [1, 2],
                 "keep": 0.5, "space": SPACE, "suggester": "gp"}
    out = tmp_path / "results.json"
    calls = []

    def crashy(c):
        if len(calls) >= 4:
            # a hard crash: BaseException escapes the trial's Exception net
            raise KeyboardInterrupt("simulated crash at trial 4")
        calls.append(c.run.run_name)
        return _fake_train(c)

    with pytest.raises(KeyboardInterrupt):
        run_sweep(cfg, out_path=out, train_fn=crashy)
    journal = tmp_path / "results.json.jsonl"
    assert len(journal.read_text().splitlines()) == 4

    def counting(c):
        calls.append(c.run.run_name)
        return _fake_train(c)

    results = run_sweep(cfg, out_path=out, train_fn=counting, resume=True)
    # 6 rung-0 + 3 survivors = 9 trainings total; 4 were journaled
    assert len(calls) == 9
    assert len(results) == 6
    assert out.exists()
    assert len(journal.read_text().splitlines()) == 9
    n_before = len(calls)
    results2 = run_sweep(cfg, out_path=out, train_fn=counting, resume=True)
    assert len(calls) == n_before
    assert [r["point"] for r in results2] == [r["point"] for r in results]


def test_resume_never_attaches_mismatched_journal_records(tmp_path):
    cfg = Config.default()
    cfg.run.checkpoint_dir = str(tmp_path)
    cfg.sweep = {"metric": "score", "trials": 4, "rungs": [1, 2],
                 "keep": 0.5, "space": SPACE, "suggester": "random"}
    out = tmp_path / "results.json"
    results = run_sweep(cfg, out_path=out, train_fn=_fake_train)
    journal = tmp_path / "results.json.jsonl"
    recs = [json.loads(line) for line in journal.read_text().splitlines()]
    r1 = [r for r in recs if r["rung"] == 1]
    assert len(r1) == 2
    r1[0]["point"], r1[1]["point"] = r1[1]["point"], r1[0]["point"]
    journal.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    calls = []

    def counting(c):
        calls.append(c.run.run_name)
        return _fake_train(c)

    res2 = run_sweep(cfg, out_path=out, train_fn=counting, resume=True)
    assert len(calls) == 2
    assert all("-r1-" in name for name in calls)

    def key(rs):
        return sorted((json.dumps(r["point"], sort_keys=True),
                       tuple(r["scores"])) for r in rs)

    assert key(res2) == key(results)


def test_final_ranking_is_fidelity_aware(tmp_path):
    cfg = Config.default()
    cfg.run.checkpoint_dir = str(tmp_path)
    cfg.sweep = {"metric": "score", "trials": 8, "rungs": [1, 3],
                 "keep": 0.25, "space": SPACE, "suggester": "random"}

    def decaying(c):
        base = _fake_train(c)["score"]
        return {"score": base - (100.0 if c.run.total_updates > 1 else 0.0)}

    results = run_sweep(cfg, train_fn=decaying)
    assert results[0]["rungs_completed"] == 2
    assert results[0]["score"] < min(
        r["score"] for r in results if r["rungs_completed"] == 1)


def test_run_sweep_gp_end_to_end(tmp_path):
    cfg = Config.default()
    cfg.run.checkpoint_dir = str(tmp_path)
    cfg.sweep = {"metric": "score", "trials": 12, "rungs": [1, 2],
                 "keep": 0.25, "space": SPACE, "suggester": "gp"}
    results = run_sweep(cfg, train_fn=_fake_train)
    assert len(results) == 12
    assert results[0]["score"] > -0.5
    front = [r for r in results if r["pareto"]]
    assert front and max(r["score"] for r in front) == results[0]["score"]


def test_run_sweep_trains_on_cpu(tmp_path):
    """A real sweep: two trials of two updates each through train.train on
    the CPU (the kernels' plain versions), scored by ep_return_mean."""
    cfg = Config.default().with_overrides([
        "train.num_envs=256", "train.horizon=8", "train.num_minibatches=2",
        "train.epochs=1", "run.hidden=16,16", "run.log_interval=1",
        f"run.checkpoint_dir={tmp_path}", "env.params.horizon=6"])
    cfg.sweep = {"metric": "ep_return_mean", "trials": 2, "rungs": [2],
                 "space": {"train.lr": {"log": [1e-4, 1e-2]}},
                 "suggester": "random"}
    out = tmp_path / "sweep.json"
    results = run_sweep(cfg, out_path=out, device="cpu")
    assert len(results) == 2
    assert all(math.isfinite(r["score"]) for r in results)
    assert json.loads(out.read_text()) == results
    runs = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert runs == ["run-sweep-r0-t0", "run-sweep-r0-t1"]
