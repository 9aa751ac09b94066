"""An evaluation cell: `train.evaluate(cfg, runner, episodes, deterministic
=True)` called back to back, the path of `cli eval`.

Every call evaluates fresh episodes: call i runs with run.seed = seed + i
(evaluate() starts its lanes from run.seed + 1). Call 0 is the warm-up;
the window's calls are 1, 2, ... Each call returns its episode statistics
as host floats, so each ends with a value read. One call of the window,
drawn from the seed among its first `checked_within`, is compared: its
statistics, and the acting kernel's per-lane output of it (each lane's
sums and final state, kept by a wrapper around the kernel's entry point
that returns what it returns). Once the window has closed and the
memory's peak is read, the plain reference (benchmark/reference/evaluate)
recomputes that call.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import random
import time
from types import SimpleNamespace

from benchmark.harness import program, trace, weights
from benchmark.harness.view import View
from benchmark.reference import env as ref_env
from benchmark.reference import evaluate as ref_eval
from benchmark.reference import nets

STATS = ("episodes", "ep_return_mean", "ep_return_std", "ep_length_mean")
# the acting kernels' entry points evaluate() reaches, and their plain
# versions (a CPU run)
ACTING = (("cuda_acting", "act_rollout_kernel"),
          ("cuda_acting", "act_rollout_plain"),
          ("cuda_acting_lstm", "lstm_act_rollout_kernel"),
          ("cuda_acting_lstm", "lstm_act_rollout_plain"))


class Lanes:
    """Keeps the per-lane output (final state, per-lane statistics) of the
    acting kernel's `want`-th call, and of its last."""

    def __init__(self, want: int):
        self.want, self.calls, self.kept, self.last = want, 0, None, None
        self._saved = []

    def __enter__(self):
        import importlib

        for mod, name in ACTING:
            m = importlib.import_module(f"drone_tpu_torch.ops.{mod}")
            fn = getattr(m, name)
            self._saved.append((m, name, fn))
            setattr(m, name, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for m, name, fn in self._saved:
            setattr(m, name, fn)

    def _wrap(self, fn):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.calls += 1
            self.last = (out[0], out[-1])
            if self.calls == self.want:
                self.kept = self.last
            return out

        return recorded


def run(ctx) -> dict:
    import torch

    from drone_tpu_torch import train as T

    wl, tables, dev = ctx.workload, ctx.tables, ctx.device
    cfg = program.config(tables, ctx.seed)
    compile_s = program.build_sources(wl["sources"], dev)
    lanes = int(wl["episodes"])
    sd = weights.make(nets.param_shapes(tables["run"]), ctx.seed, dev)
    holder = SimpleNamespace(params=sd)
    checked = random.Random(ctx.seed).randint(1, int(wl["checked_within"]))

    def call(i: int) -> dict:
        c = dataclasses.replace(cfg, run=dataclasses.replace(
            cfg.run, seed=ctx.seed + i))
        return T.evaluate(c, holder, episodes=lanes, deterministic=True,
                          device=dev)

    horizon = int(tables.get("env", {}).get("horizon",
                                             ref_env.DEFAULTS["horizon"])) + 1
    answers, failed = [], 0
    with Lanes(want=checked + 1) as rec:  # call 0 is the kernel's first
        call(0)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - ctx.t0
        t0 = time.perf_counter()
        while True:
            out = call(len(answers) + 1)
            answers.append(out)
            if not all(math.isfinite(float(out[k])) for k in STATS):
                failed += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window_s = time.perf_counter() - t0
    n = len(answers)
    if rec.kept is None:  # the window held fewer calls: compare its last
        checked, rec.kept = n, rec.last
    e2e = {"setup_s": setup_s,
           "env_steps_per_s": n * lanes * horizon / window_s}
    ctx.log(f"window: {n} calls in {window_s:.3f} s, mean episode length "
            f"{sum(a['ep_length_mean'] for a in answers) / n:.2f} steps, "
            f"compile {compile_s:.1f} s")

    view = None
    if ctx.trace:
        nxt = {"i": n + 1}

        def unit():
            out = call(nxt["i"])
            nxt["i"] += 1
            return out["episodes"]

        try:
            tr = trace.record(unit, float(wl.get("trace_seconds", 4.0)))
        except RuntimeError as e:
            ctx.log(f"trace: not measured ({e})")
            tr = None
        view = View(entry="eval", trace=tr, kernels=ctx.kernels,
                    step=ctx.step, peak_flops=ctx.peak_flops,
                    peak_bytes_per_s=ctx.peak_bytes_per_s,
                    unit_work=lanes * horizon)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    prog = (answers[checked - 1], rec.kept)
    del rec
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    checks = gaps(prog, reference(ctx, sd, checked))
    ctx.log(f"reference: call {checked}, {time.perf_counter() - t:.1f} s")
    return {"e2e": e2e, "view": view, "checks": checks, "attempted": n,
            "failed": failed, "memory_peak_bytes": peak,
            "compile_s": compile_s}


def reference(ctx, sd, i: int, prec: str = "fp32", episodes=None):
    """The reference's (statistics, per-lane sums, final state) of window
    call i."""
    nets.fp32_products()
    return ref_eval.evaluate(ctx.tables, sd, ctx.seed + i + 1,
                             episodes or int(ctx.workload["episodes"]),
                             ctx.device, prec, lanes=True)


def gaps(prog, ref) -> dict:
    """The numbers a run can compare, of (statistics, (final state, per-lane
    statistics)) of the program and (statistics, per-lane sums, final
    state) of the reference; the workload's limits name those it does."""
    (stats, (final, lane)), (rstats, racc, rfinal) = prog, ref
    out = {f"{k}_gap": program.rel(float(stats[k]), float(rstats[k]))
           for k in STATS}
    out["stats_gap"] = stats_gap(stats, rstats)
    n = min(lane.shape[1], racc.shape[1])
    # the per-lane statistics' rows: reward, episodes, return, length,
    # return squared (the program's); episodes, return, return squared,
    # length (the reference's)
    p_ret, r_ret = lane[2, :n].double(), racc[1, :n]
    ep_differ = lane[1, :n].double() != racc[0, :n]
    len_differ = lane[3, :n].double() != racc[3, :n]
    out["lanes_apart"] = float((ep_differ | len_differ).double().mean())
    # the median lane's gap of its episodes' return sum, and of its final
    # position (m)
    out["lane_gap"] = float(((p_ret - r_ret).abs()
                             / r_ret.abs().clamp_min(1.0)).median())
    out["state_gap"] = float((final.pos[:n] - rfinal["pos"][:n])
                             .abs().amax(1).median())
    return out


def stats_gap(prog: dict, ref: dict) -> float:
    """The widest relative gap over the episode statistics."""
    return max(program.rel(float(prog[k]), float(ref[k])) for k in STATS)
