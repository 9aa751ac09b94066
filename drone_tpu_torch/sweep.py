"""Hyperparameter sweep engine: model-based suggestion + successive halving
(counterpart of `drone_tpu/sweep.py`, the same engine over the port's
`train.train`).

The suggester's arithmetic is numpy's, as the reference's, so the same seed
and the same observations give the same points bit for bit. Two changes:
`run_sweep` takes `device` ("cuda" by default) and reaches
`train.train(cfg, device=...)` through a module-level function, so that
it pickles; and with `workers > 1` the pool starts its workers with spawn,
not fork: a one-trial batch runs in this process, which then holds a CUDA
context, and a child forked from it could not initialise CUDA again. Each
spawned worker loads the kernels `ops.cuda_build.build` left in the build
directory.

What the engine does (Protein, a Pareto-aware model-based engine that
suggests hyperparameters from [sweep] ranges, runs a training, scores it,
updates its model, repeats):

  - **GP-EI suggester** (`GPSuggester`): a NumPy-only Gaussian process over
    the unit-cube encoding of the search space, suggesting the
    expected-improvement maximizer over a candidate pool (half global
    random, half perturbations of the incumbent). No new dependencies.
  - **Cost-aware acquisition** (`suggester = "gp_pareto"`): a second GP fits
    the observed per-trial cost (wall-clock seconds) and suggestion
    maximizes EI *per unit predicted cost* — Protein's defining behavior:
    the cost/score tradeoff shapes WHICH points get suggested, not just how
    results are reported. At equal EI the cheaper region wins.
  - **Successive halving** across fidelity rungs (updates per trial), as
    before — the GP drives WHICH points enter rung 0, halving decides who
    gets more budget. Final ranking is fidelity-aware: trials are ranked by
    (rungs completed, last score), so a noisy rung-0 score never outranks a
    survivor's top-rung score.
  - **Cost-aware Pareto front**: every result carries (cost = total updates
    spent, score); `pareto_front` reports the non-dominated set, Protein's
    cost/score tradeoff surface.
  - **Durable sweeps**: every completed trial appends one record to a JSONL
    journal next to `out_path` as it finishes; `resume=True` replays the
    journal (suggester observations included) and skips the work already
    done — a crash at trial 15/16 costs one trial, not the sweep.
  - **Parallel trial launcher**: `workers > 1` evaluates trials in
    process-parallel batches (suggest a batch, run via a spawn
    ProcessPoolExecutor, observe all). One card runs the workers' kernels
    in turn, which is why the default stays sequential.

  [sweep] section format (TOML):
      metric = "ep_return_mean"       # maximized
      trials = 16
      rungs = [50, 200]               # updates per fidelity rung
      keep = 0.5                      # fraction promoted per rung
      suggester = "gp"                # "gp" | "gp_pareto" | "random"
      workers = 1
      [sweep.space]
      "train.lr" = {log = [1e-4, 1e-2]}
      "train.ent_coef" = {log = [1e-5, 1e-2]}
      "train.clip_eps" = {lin = [0.1, 0.3]}
      "train.num_minibatches" = {choice = [2, 4, 8]}
"""

from __future__ import annotations

import functools
import json
import math
import multiprocessing
import random
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from pathlib import Path

import numpy as np

from drone_tpu_torch.utils.config import Config


def sample_point(space: dict, rng: random.Random) -> dict:
    point = {}
    for key, spec in space.items():
        if "log" in spec:
            lo, hi = spec["log"]
            point[key] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
        elif "lin" in spec:
            lo, hi = spec["lin"]
            point[key] = rng.uniform(lo, hi)
        elif "choice" in spec:
            point[key] = rng.choice(spec["choice"])
        else:
            raise ValueError(f"unknown space spec for {key}: {spec}")
    return point


def apply_point(cfg: Config, point: dict) -> Config:
    overrides = [f"{k}={v}" for k, v in point.items()]
    return cfg.with_overrides(overrides)


class GPSuggester:
    """Expected-improvement suggestion over a unit-cube GP surrogate.

    Encoding: log ranges -> log-linear in [0,1]; lin ranges -> linear;
    choice -> ordinal index/(n-1) (crude for truly unordered categories,
    fine for the numeric ladders hyperparameter sweeps actually use).
    The GP is an RBF kernel with a fixed length scale on the unit cube and
    an observation nugget; scores are standardized before fitting. Failed
    trials (NaN/-inf) are kept as the current worst score so the surrogate
    learns to avoid the region instead of resampling it.
    """

    def __init__(self, space: dict, seed: int = 0, length_scale: float = 0.3,
                 noise: float = 1e-2, candidates: int = 256, xi: float = 0.01,
                 n_init: int | None = None, cost_aware: bool = False):
        self.space = space
        self.keys = sorted(space)
        self.rng = random.Random(seed)
        self.np_rng = np.random.default_rng(seed)
        self.ls = length_scale
        self.noise = noise
        self.candidates = candidates
        self.xi = xi
        self.n_init = n_init if n_init is not None else max(4, len(self.keys))
        self.cost_aware = cost_aware
        self.X: list[np.ndarray] = []
        self.y: list[float] = []
        self.costs: list[float] = []      # observed wall-clock seconds
        self._worst_finite: float | None = None

    # -- encoding ------------------------------------------------------------
    def _encode(self, point: dict) -> np.ndarray:
        u = np.empty(len(self.keys))
        for i, k in enumerate(self.keys):
            spec = self.space[k]
            v = point[k]
            if "log" in spec:
                lo, hi = spec["log"]
                u[i] = (math.log(v) - math.log(lo)) / (
                    math.log(hi) - math.log(lo))
            elif "lin" in spec:
                lo, hi = spec["lin"]
                u[i] = (v - lo) / (hi - lo)
            else:
                opts = spec["choice"]
                u[i] = (opts.index(v) / (len(opts) - 1)
                        if len(opts) > 1 else 0.5)
        return np.clip(u, 0.0, 1.0)

    def _decode(self, u: np.ndarray) -> dict:
        point = {}
        for i, k in enumerate(self.keys):
            spec = self.space[k]
            x = float(np.clip(u[i], 0.0, 1.0))
            if "log" in spec:
                lo, hi = spec["log"]
                v = math.exp(math.log(lo) + x * (math.log(hi) - math.log(lo)))
                point[k] = min(hi, max(lo, v))  # exp/log roundoff at bounds
            elif "lin" in spec:
                lo, hi = spec["lin"]
                point[k] = min(hi, max(lo, lo + x * (hi - lo)))
            else:
                opts = spec["choice"]
                point[k] = opts[int(round(x * (len(opts) - 1)))]
        return point

    # -- surrogate -----------------------------------------------------------
    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.ls * self.ls))

    def _fit(self):
        X = np.stack(self.X)
        y = np.asarray(self.y, dtype=float)
        mu, sd = y.mean(), y.std()
        sd = sd if sd > 1e-12 else 1.0
        ys = (y - mu) / sd
        K = self._kernel(X, X) + (self.noise + 1e-8) * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, ys))
        return X, ys, mu, sd, L, alpha

    def _ei(self, U: np.ndarray, X, ys, L, alpha) -> np.ndarray:
        Ks = self._kernel(U, X)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.clip(1.0 - (v * v).sum(0), 1e-12, None)
        s = np.sqrt(var)
        best = ys.max()
        z = (mu - best - self.xi) / s
        Phi = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))
        phi = np.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
        return (mu - best - self.xi) * Phi + s * phi

    def _predict_cost(self, U: np.ndarray, X: np.ndarray) -> np.ndarray:
        """Posterior-mean wall-clock cost at the candidates (log-space GP so
        the prediction is positive and multiplicative effects are additive);
        falls back to 1.0 (cost-neutral) until costs are observed."""
        c = np.asarray(self.costs, dtype=float)
        good = np.isfinite(c) & (c > 0)
        if good.sum() < 2:
            return np.ones(len(U))
        Xg = X[good]
        lc = np.log(c[good])
        mu, sd = lc.mean(), lc.std()
        sd = sd if sd > 1e-12 else 1.0
        lcs = (lc - mu) / sd
        K = self._kernel(Xg, Xg) + (self.noise + 1e-8) * np.eye(len(Xg))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, lcs))
        pred = self._kernel(U, Xg) @ alpha * sd + mu
        return np.exp(pred)

    # -- public API ----------------------------------------------------------
    def suggest(self) -> dict:
        if len(self.X) < self.n_init:
            return sample_point(self.space, self.rng)
        X, ys, _, _, L, alpha = self._fit()
        n_rand = self.candidates // 2
        U = self.np_rng.random((n_rand, len(self.keys)))
        incumbent = X[int(np.argmax(ys))]
        local = incumbent[None, :] + 0.1 * self.np_rng.standard_normal(
            (self.candidates - n_rand, len(self.keys)))
        U = np.clip(np.concatenate([U, local]), 0.0, 1.0)
        acq = self._ei(U, X, ys, L, alpha)
        if self.cost_aware:
            # Protein-style Pareto pressure: improvement per unit cost, so
            # at equal EI the cheaper region wins the suggestion
            acq = acq / np.maximum(self._predict_cost(U, X), 1e-9)
        return self._decode(U[int(np.argmax(acq))])

    def observe(self, point: dict, score: float, cost: float = float("nan")):
        """Record a result. cost: trial wall-clock seconds (used only by
        cost_aware acquisition; NaN = unknown)."""
        if not math.isfinite(score):
            if self._worst_finite is None:
                # no real score yet: there is no scale to anchor a penalty
                # to (0.0-1.0 would make a crash the BEST point whenever
                # the metric runs negative, attracting the GP to the
                # failing region) — skip the observation; early failures
                # are covered by the n_init random-exploration phase
                return
            # learn to avoid the region, finitely: one step below the worst
            # REAL score (penalizing off min(self.y) would ratchet, since
            # self.y already contains prior penalties)
            score = self._worst_finite - 1.0
        else:
            self._worst_finite = (score if self._worst_finite is None
                                  else min(self._worst_finite, score))
        self.X.append(self._encode(point))
        self.y.append(float(score))
        self.costs.append(float(cost))


def pareto_front(results: list[dict], cost_key: str = "cost",
                 score_key: str = "score") -> list[dict]:
    """Non-dominated subset: no other trial has (cost <=, score >=) with at
    least one strict. Sorted by cost ascending."""
    front = []
    for r in results:
        dominated = any(
            o is not r
            and o[cost_key] <= r[cost_key] and o[score_key] >= r[score_key]
            and (o[cost_key] < r[cost_key] or o[score_key] > r[score_key])
            for o in results)
        if not dominated:
            front.append(r)
    return sorted(front, key=lambda r: (r[cost_key], -r[score_key]))


def _trial_cfg(cfg: Config, point: dict, updates: int, name: str) -> Config:
    c = apply_point(cfg, point)
    c.run.total_updates = int(updates)
    c.run.run_name = name
    c.run.checkpoint_interval = 10 ** 9
    c.run.save_final = False
    # each trial logs under its OWN run dir: an explicit base metrics_path
    # would make every (possibly concurrent) trial append to one file
    c.run.metrics_path = ""
    return c


def _default_train_fn(cfg, device="cuda"):
    from drone_tpu_torch.train import train as _train

    return _train(cfg, device=device)[1]


def _timed_call(train_fn, cfg):
    t0 = time.perf_counter()
    try:
        final = train_fn(cfg)
    except Exception as e:  # noqa: BLE001 — a diverged/crashed trial is a
        # data point (score -inf feeds the suggester's failure penalty),
        # not a reason to abort the sweep or discard its batch-mates
        print(f"[sweep] trial failed: {e!r}")
        final = None
    return final, time.perf_counter() - t0


def _read_journal(path: Path) -> dict:
    """Journal JSONL -> {(rung, idx): record}. Tolerates a torn final line
    (the crash that motivated the journal)."""
    done = {}
    if path.exists():
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn write at crash time
            done[(int(rec["rung"]), int(rec["idx"]))] = rec
    return done


def _rank_key(t):
    """Halving-promotion order: best last score first, score ties broken by
    the canonical point (NOT by population insertion order, which differs
    between an original parallel run — completion order — and a journal
    replay — index order; positional (rung, j) journal keys need the sort
    to be a pure function of the (point, score) set)."""
    return (-t["scores"][-1], json.dumps(t["point"], sort_keys=True))


def run_sweep(cfg: Config, out_path: str | Path | None = None,
              train_fn=None, workers: int | None = None,
              resume: bool = False,
              journal_path: str | Path | None = None,
              device="cuda") -> list[dict]:
    """GP-guided (or random) search with successive halving.

    Returns trial records sorted best-first (fidelity-aware: by rungs
    completed, then by the score at the highest rung reached — a noisy
    rung-0 score never outranks a survivor's top-rung score); each record
    carries point, per-rung scores, total cost (updates spent), and whether
    it sits on the cost/score Pareto front. train_fn(cfg) -> final metrics
    dict (injectable for tests; must be module-level picklable for
    workers > 1); by default `train.train(cfg, device=device)`'s last
    logged record.

    Durability: every completed trial appends one line to `journal_path`
    (default: `<out_path>.jsonl`, else
    `<checkpoint_dir>/<run_name>-sweep.jsonl`) as it finishes; with
    resume=True, journaled (rung, idx) trials are replayed — suggester
    observations included — instead of re-trained.
    """
    train_fn = train_fn or functools.partial(_default_train_fn,
                                             device=device)
    sweep = dict(cfg.sweep)
    metric = sweep.get("metric", "ep_return_mean")
    trials = int(sweep.get("trials", 8))
    rungs = list(sweep.get("rungs", [50]))
    keep = float(sweep.get("keep", 0.5))
    suggester_kind = str(sweep.get("suggester", "gp"))
    workers = int(workers if workers is not None else sweep.get("workers", 1))
    if workers < 1:
        raise ValueError(f"sweep.workers must be >= 1, got {workers} "
                         f"(0 would loop forever building empty batches)")
    space = sweep.get("space", {})
    if not space:
        raise ValueError("[sweep.space] is empty — nothing to search")

    if journal_path is not None:
        journal = Path(journal_path)
    elif out_path is not None:
        journal = Path(out_path).with_suffix(Path(out_path).suffix + ".jsonl")
    else:
        journal = (Path(cfg.run.checkpoint_dir)
                   / f"{cfg.run.run_name}-sweep.jsonl")
    journal.parent.mkdir(parents=True, exist_ok=True)
    done = _read_journal(journal) if resume else {}
    if not resume and journal.exists():
        journal.unlink()  # a fresh sweep must not inherit a stale journal

    def journal_write(rec: dict):
        with journal.open("a") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()

    rng = random.Random(cfg.run.seed)
    if suggester_kind in ("gp", "gp_pareto"):
        sug = GPSuggester(space, seed=cfg.run.seed,
                          cost_aware=suggester_kind == "gp_pareto")
    elif suggester_kind == "random":
        sug = None
    else:
        raise ValueError(f"sweep.suggester must be 'gp', 'gp_pareto' or "
                         f"'random', got {suggester_kind!r}")

    def score_of(final) -> float:
        if not final:
            return float("-inf")  # crashed/diverged trial
        if metric not in final:
            # a typo'd sweep.metric must error on the FIRST completed trial,
            # not silently score the whole budget -inf
            raise KeyError(
                f"sweep.metric {metric!r} is not in the trial metrics "
                f"(available: {sorted(final)})")
        s = float(final[metric])
        return float("-inf") if math.isnan(s) else s

    def run_batch(cfgs):
        """Yield (pos, final_metrics, seconds) in COMPLETION order: the
        caller journals every finished trial before any slower batch-mate
        resolves, so a sweep-process death mid-batch loses only the trials
        still in flight (yielding in submission order would hold completed
        results hostage behind a slow futs[0]); a worker that dies outright
        (OOM-kill and the like) yields (pos, None, nan) instead of
        discarding its batch-mates. The resume replay tolerates the
        resulting journal gaps: missing indices simply re-train."""
        if workers > 1 and len(cfgs) > 1:
            # spawn: this process may hold a CUDA context (a one-trial
            # batch trains here), which a forked child cannot re-initialise
            with ProcessPoolExecutor(
                    max_workers=workers,
                    mp_context=multiprocessing.get_context("spawn")) as ex:
                futs = {ex.submit(_timed_call, train_fn, c): k
                        for k, c in enumerate(cfgs)}
                for f in as_completed(futs):
                    try:
                        final, secs = f.result()
                    except Exception as e:  # noqa: BLE001 — process death
                        print(f"[sweep] trial worker died: {e!r}")
                        final, secs = None, float("nan")
                    yield futs[f], final, secs
        else:
            for k, c in enumerate(cfgs):
                final, secs = _timed_call(train_fn, c)
                yield k, final, secs

    def record(rung, idx, point, score, seconds):
        if sug:
            sug.observe(point, score, cost=seconds)
        journal_write({"rung": rung, "idx": idx, "point": point,
                       "score": score, "seconds": seconds})
        print(f"[sweep] rung {rung} trial {idx}: {metric}={score:.3f} "
              f"point={point}")

    # -- rung 0: suggestion-driven, in parallel batches ----------------------
    population = []
    i = 0
    while i < trials:
        # replay journaled trials in order (their points feed the suggester
        # exactly as the original run's did), batch up the missing ones
        if (0, i) in done:
            rec = done[(0, i)]
            s = rec["score"] if rec["score"] is not None else float("-inf")
            if sug:
                sug.observe(rec["point"], s, cost=rec.get("seconds",
                                                          float("nan")))
            population.append({"point": rec["point"], "scores": [s],
                               "cost": int(rungs[0])})
            i += 1
            continue
        batch = []
        for j in range(min(workers, trials - i)):
            if (0, i + j) in done:
                break  # keep replay ordering intact
            point = sug.suggest() if sug else sample_point(space, rng)
            batch.append(point)
        cfgs = [_trial_cfg(cfg, p, rungs[0],
                           f"{cfg.run.run_name}-sweep-r0-t{i + j}")
                for j, p in enumerate(batch)]
        for k, final, secs in run_batch(cfgs):
            s = score_of(final)
            record(0, i + k, batch[k], s, secs)
            population.append({"point": batch[k], "scores": [s],
                               "cost": int(rungs[0])})
        i += len(batch)

    # -- later rungs: successive halving of the survivors --------------------
    for rung_idx, updates in enumerate(rungs[1:], start=1):
        population.sort(key=_rank_key)
        survivors = population[: max(1, int(len(population) * keep))]

        def _replay(j, t, rung_idx=rung_idx):
            rec = done.get((rung_idx, j))
            return rec if rec and rec["point"] == t["point"] else None

        todo = [(j, t) for j, t in enumerate(survivors)
                if _replay(j, t) is None]
        for j, t in enumerate(survivors):
            rec = _replay(j, t)
            if rec is not None:
                s = (rec["score"] if rec["score"] is not None
                     else float("-inf"))
                t["scores"].append(s)
                t["cost"] += int(updates)
                if sug:
                    sug.observe(t["point"], s,
                                cost=rec.get("seconds", float("nan")))
        cfgs = [_trial_cfg(cfg, t["point"], updates,
                           f"{cfg.run.run_name}-sweep-r{rung_idx}-t{j}")
                for j, t in todo]
        for k, final, secs in run_batch(cfgs):
            j, t = todo[k]
            s = score_of(final)
            t["scores"].append(s)
            t["cost"] += int(updates)
            record(rung_idx, j, t["point"], s, secs)

    # fidelity-aware ranking: a trial promoted through more rungs ranks
    # above any trial that stalled earlier, regardless of raw score
    population.sort(key=lambda t: (-len(t["scores"]), -t["scores"][-1]))
    for t in population:
        t["score"] = t["scores"][-1]
        t["rungs_completed"] = len(t["scores"])
    front = pareto_front(population)
    for t in population:
        t["pareto"] = t in front
    results = [{k: t[k] for k in ("point", "scores", "score", "cost",
                                  "rungs_completed", "pareto")}
               for t in population]
    if out_path:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        Path(out_path).write_text(json.dumps(results, indent=2))
    return results
