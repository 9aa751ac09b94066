"""A training cell: `train.build(cfg)`'s step, run back to back.

Set-up builds the step and its runner through `train.build` (the path of
`cli train`), loads the seed's weights, and drives the step through the
workload's first updates (`checked_updates`), which also warm up every
shape the window uses. The window then runs the same step on the same
runner for `--seconds`, with no checkpoint and no metrics logger, reading
the loss every `run.log_interval` updates as `train.train` does; it ends
with a value read. Once it has closed and the memory's peak is read, the
program's state is freed and the plain reference (benchmark/reference/ppo)
follows the first updates from the seed, for the comparison.

With tracing on, the step is the trainer maker's own (`ppo_cuda` /
`ppo_rnn_cuda`, the one `train.build` returns when no mesh is set) built
with an `on_phase` that records a CUDA event at each phase mark, and a
profiled window follows the timed one.
"""

from __future__ import annotations

import gc
import math
import time

from benchmark.harness import program, trace, weights
from benchmark.harness.view import View
from benchmark.reference import nets, ppo


class Marks:
    """CUDA events at the trainer's phase marks, one list an update."""

    def __init__(self):
        self.updates = []

    def mark(self, name):
        import torch

        if name == "rollout":
            self.updates.append([])
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.updates[-1].append((name, ev))

    def phase_ms(self) -> dict:
        out = {}
        for marks in self.updates:
            for (name, e0), (_, e1) in zip(marks, marks[1:]):
                out.setdefault(name, []).append(e0.elapsed_time(e1))
        return out


def _leaves(flat, order) -> dict:
    """{name: view} of a flat buffer split by a kernel order."""
    out, off = {}, 0
    for name, shape in order:
        n = math.prod(shape)
        out[name] = flat[off:off + n].view(shape)
        off += n
    return out


def start(ctx) -> dict:
    """Set-up: the step and runner of `train.build`, the seed's weights,
    and the first updates, with what the comparison needs of them."""
    from drone_tpu_torch import ppo_cuda, ppo_rnn_cuda
    from drone_tpu_torch import train as T

    wl, tables, dev = ctx.workload, ctx.tables, ctx.device
    cfg = program.config(tables, ctx.seed)
    compile_s = program.build_sources(wl["sources"], dev)
    env, model, runner, step, bcfg = T.build(cfg, device=dev)
    if step.kind != "megakernel" or step.mesh is not None:
        raise RuntimeError(f"train.build picked the {step.kind} trainer "
                           f"(mesh {step.mesh}); the cell measures the "
                           f"megakernel trainer on one chip")
    recurrent = bcfg.run.policy in ("lstm", "cnn_lstm")
    trainer = ppo_rnn_cuda if recurrent else ppo_cuda
    marks = None
    if ctx.trace:
        marks = Marks()
        maker = (ppo_rnn_cuda.make_rnn_train_step if recurrent
                 else ppo_cuda.make_train_step)
        step = maker(env, bcfg.train, on_phase=marks.mark,
                     compute_dtype=bcfg.run.compute_dtype)
    sd = weights.make(nets.param_shapes(tables["run"]), ctx.seed, dev)
    runner.params.load_state_dict(sd)
    order = runner.params.kernel_order()

    first = {}
    adam = trainer.fused_adam_cuda

    def first_adam(theta, grads, mu, nu, count, *args, **kw):
        out = adam(theta, grads, mu, nu, count, *args, **kw)
        if "mu" not in first:  # the first gradient as the optimizer got it
            first["mu"] = {k: v.clone() for k, v in _leaves(mu, order).items()}
        return out

    trainer.fused_adam_cuda = first_adam
    try:
        checked = []
        for _ in range(int(wl["checked_updates"])):
            runner, m = step(runner)
            checked.append({k: m[k] for k in ("loss", "episodes",
                                               "reward_mean")})
    finally:
        trainer.fused_adam_cuda = adam
    return {"env": env, "model": model, "runner": runner, "step": step,
            "cfg": bcfg, "marks": marks, "sd": sd, "compile_s": compile_s,
            "prog": ([{k: float(v) for k, v in c.items()} for c in checked],
                     first["mu"],
                     {k: v.detach().clone()
                      for k, v in runner.params.state_dict().items()},
                     (runner.env_state.step.long(),
                      runner.env_state.reset_count.long() & 0xFFFFFFFF,
                      runner.env_state.pos.clone()))}


def run(ctx) -> dict:
    import torch

    dev = ctx.device
    st = start(ctx)
    runner, step, marks, wl = st["runner"], st["step"], st["marks"], ctx.workload
    compile_s, bcfg = st["compile_s"], st["cfg"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - ctx.t0

    # --- the window ----------------------------------------------------------
    tc = bcfg.train
    samples = tc.num_envs * tc.horizon
    read_every = int(bcfg.run.log_interval)
    if marks:
        marks.updates.clear()
    events, host_s, failed = [], [], 0

    def event():
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

    n = 0
    t0 = time.perf_counter()
    event()
    while True:
        h0 = time.perf_counter()
        runner, m = step(runner)
        h1 = time.perf_counter()
        event()
        host_s.append(h1 - h0)
        n += 1
        if n % read_every == 0 and not math.isfinite(float(m["loss"])):
            failed += 1
        if h1 - t0 >= ctx.seconds:
            break
    if not math.isfinite(float(m["loss"])):  # the read that ends the window
        failed += 1
    window_s = time.perf_counter() - t0
    # on the card the CUDA events between step calls; on the CPU, where a
    # step runs as it is called, the host clock of each call
    update_ms = ([a.elapsed_time(b) for a, b in zip(events, events[1:])]
                 if events else [1e3 * h for h in host_s])
    e2e = {"setup_s": setup_s, "train_samples_per_s": n * samples / window_s}
    if update_ms:
        e2e["update_ms_p95"] = program.percentile(update_ms, 95)
    ctx.log(f"window: {n} updates in {window_s:.3f} s, update ms median "
            f"{program.percentile(update_ms, 50) if update_ms else 'n/a'}, "
            f"compile {compile_s:.1f} s")

    view = None
    if ctx.trace:
        phases = marks.phase_ms()
        state = {"runner": runner}

        def unit():
            state["runner"], mm = step(state["runner"])
            return mm["loss"]

        try:
            tr = trace.record(unit, float(wl.get("trace_seconds", 4.0)))
        except RuntimeError as e:
            ctx.log(f"trace: not measured ({e})")
            tr = None
        runner = state["runner"]
        view = View(entry="train", trace=tr, kernels=ctx.kernels,
                    step=ctx.step, peak_flops=ctx.peak_flops,
                    peak_bytes_per_s=ctx.peak_bytes_per_s, unit_work=samples,
                    phases=phases, host_queue_s=host_s)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    sd, prog = st["sd"], st["prog"]
    del runner, step, m, st
    free(dev)
    t = time.perf_counter()
    checks = gaps(sd, prog, reference(ctx, sd))
    ctx.log(f"reference: {time.perf_counter() - t:.1f} s")
    return {"e2e": e2e, "view": view, "checks": checks, "attempted": n,
            "failed": failed, "memory_peak_bytes": peak,
            "compile_s": compile_s}


def reference(ctx, sd, prec="fp32", half_batch=False, frozen=False):
    """The reference run of the cell's first updates: (per-update
    metrics, first Adam moment, parameters after, env lanes after).
    half_batch, frozen: planted faults (calibrate.py)."""
    nets.fp32_products()
    ref = ppo.Run(ctx.tables, sd, ctx.seed, ctx.device, prec=prec,
                  half_batch=half_batch, frozen=frozen)
    mets = [ref.update() for _ in range(int(ctx.workload["checked_updates"]))]
    lanes = (ref.state["step"], ref.state["episode"], ref.state["pos"])
    return mets, ref.first_mu, ref.p, lanes


def gaps(sd, prog, ref) -> dict:
    """The numbers a run can compare, of (metrics, first moment,
    parameters, env lanes) of the program and of the reference; the
    workload's limits name those it does."""
    (pm, pmu, pth, pl), (rm, rmu, rth, rl) = prog, ref
    norms = {k: float(v.double().norm()) for k, v in rmu.items()}
    med = sorted(norms.values())[len(norms) // 2]
    moved = {k for k, v in norms.items() if v >= 1e-3 * med}
    out = {}
    for u, (p, r) in enumerate(zip(pm, rm), 1):
        out[f"loss_gap_{u}"] = program.rel(p["loss"], r["loss"])
        out[f"rollout_gap_{u}"] = max(
            program.rel(p["episodes"], r["episodes"], 1.0),
            program.rel(p["reward_mean"], r["reward_mean"], 1.0))
    n = len(pm)
    out["loss_gap"] = max(out[f"loss_gap_{u}"] for u in range(1, n + 1))
    out["rollout_gap"] = max(out[f"rollout_gap_{u}"]
                             for u in range(1, n + 1))
    out["grad_gap"] = program.worst_leaf(pmu, rmu)
    out["change_gap"] = program.worst_leaf(
        {k: pth[k] - sd[k] for k in rth}, {k: rth[k] - sd[k] for k in rth},
        moved)
    differ = (pl[0] != rl[0]) | (pl[1] != rl[1])
    out["lanes_apart"] = float(differ.double().mean())
    # the carried env state: the median lane's largest position gap (m)
    out["state_gap"] = float((pl[2] - rl[2]).abs().amax(1).median())
    return out


def free(dev):
    """Return the program's freed memory to the card before the reference
    runs."""
    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

