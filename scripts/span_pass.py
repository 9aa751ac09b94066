"""The program's spans over a run of train steps or evaluate() calls, read
against a torch.profiler trace of the same run.

Run from the root of a checkout on a machine with a CUDA device:

    python3 scripts/span_pass.py <config.toml> train|eval [--seed N]
        [--seconds S] [--episodes N] [--out DIR] [--device cpu]
        [key=value ...]

(`--device cpu` rehearses the run on the CPU at a small size: no device
numbers.)

The run is the config file's (its run, env and train tables, then the
overrides): `train.build`'s step back to back, or `evaluate(episodes=N,
deterministic=True)` back to back on the built model's weights with
run.seed advanced each call. After a warm-up it runs four profiled
windows of at least --seconds each, each after one unit: recording off,
on, on, off (`profiling.recording()`); the spans of the last window with
recording on are read against its trace (`Record.read_trace`). It prints
one JSON line: the card and its power limit, each window's mean unit
milliseconds (host clock; the ratio of the means is what recording
costs), and per update (train) or call (eval) of the recorded window:

- train: `host_ms` of `drone.train_step`, `host_busy_ms` (that less its
  `runtime_ms`, the host's time inside CUDA calls: launch back-pressure
  and waits), `gae_launches` (under `drone.train_step.gae`), `host_syncs`
  (under `drone.train_step`), `phase_cover` (the four phases' host time
  over the step's, %), each phase's host and device milliseconds, and
  `synced`: the step's and each phase's host milliseconds in a last run
  without the profiler, the card drained before each step (`host_ms`
  there is the host's own time while the launch queue never fills);
- eval: `eval_setup_ms` (host time of `.build`, `.load` and
  `.init_batch`), `setup_idle_share` (the device's idle time under
  `.build`, `.load`, `.init_batch` and `.stats` over the window, %),
  `idle_share` (the window's idle time, %), `init_batch_launches`, and
  each phase's host milliseconds, device idle and launches.

`clock_ms` is the largest gap between a span's start and its annotation's
in the trace, inside the window. With --out the recorded window's
trace.json and spans.jsonl are written there.
"""
import argparse
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, ".")  # the checkout it runs from

import torch  # noqa: E402

from drone_tpu_torch import train as T  # noqa: E402
from drone_tpu_torch.utils import profiling  # noqa: E402
from drone_tpu_torch.utils.config import Config  # noqa: E402

STEP = profiling.ROOT_STEP
PHASES = ("rollout", "gae", "update", "metrics")
EVAL = "drone.evaluate"
EVAL_PHASES = ("build", "load", "init_batch", "act", "stats")
SETUP = ("build", "load", "init_batch", "stats")


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def units(args, cfg, dev):
    """unit() -> a tensor or float whose read ends a window."""
    if args.entry == "train":
        _, _, runner, step, _ = T.build(cfg, device=dev)
        state = {"runner": runner}

        def unit():
            state["runner"], m = step(state["runner"])
            return m["loss"]

        return unit
    env, model = T.build_env_and_model(cfg, dev)
    holder = SimpleNamespace(params=model.state_dict())
    calls = {"i": 0}

    def unit():
        calls["i"] += 1
        c = dataclasses.replace(cfg, run=dataclasses.replace(
            cfg.run, seed=cfg.run.seed + calls["i"]))
        return T.evaluate(c, holder, episodes=args.episodes,
                          deterministic=True, device=dev)["episodes"]

    return unit


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def window(unit, seconds: float, record: bool, dev):
    """A profiled window after one unit: (chrome trace, its start and end
    ns, units, the Record or None)."""
    from torch.profiler import ProfilerActivity, profile

    rec_ctx = profiling.recording() if record else None
    rec = rec_ctx.__enter__() if rec_ctx else None
    try:
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            float(unit())
            sync(dev)
            n, t0 = 0, time.time_ns()
            while n < 3 or time.time_ns() - t0 < seconds * 1e9:
                out = unit()
                n += 1
            float(out)
            t1 = time.time_ns()
    finally:
        if rec_ctx:
            rec_ctx.__exit__(None, None, None)
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(str(Path(d) / "trace.json"))
        chrome = json.loads((Path(d) / "trace.json").read_text())
    return chrome, t0, t1, n, rec


def synced(unit, seconds: float, dev) -> dict:
    """The step's and each phase's mean host milliseconds, recording on and
    no profiler, with the card drained before each step."""
    with profiling.recording() as rec:
        n, t0 = 0, time.time_ns()
        while n < 3 or time.time_ns() - t0 < seconds * 1e9:
            sync(dev)
            unit()
            n += 1
        sync(dev)
    out = {"updates": n}
    for name in (STEP, *(f"{STEP}.{p}" for p in PHASES)):
        out[name.rsplit(".", 1)[-1] if name != STEP else "host_ms"] = mean(
            s.host_ms for s in rec.spans if s.name == name)
    return out


def mean(values):
    """The mean of the values that are not None (None without any)."""
    values = [v for v in values if v is not None]
    return sum(values) / len(values) if values else None


def read(args, chrome, t0, t1, rec) -> dict:
    rec.read_trace(chrome)
    win = profiling.Record()
    win.close(win.open("span_pass.window", t0), t1)
    win.read_trace(chrome)
    window_ms = (t1 - t0) / 1e6
    inside = [s for s in rec.spans if t0 <= s.start_ns and s.end_ns <= t1]
    base = chrome.get("baseTimeNanoseconds", 0)
    ann = {}
    for e in chrome["traceEvents"]:
        if (e.get("cat") == "user_annotation"
                and e["name"].startswith("drone.")):
            ann.setdefault(e["name"], []).append(float(e["ts"]) * 1e3 + base)
    clock = 0.0
    for name, starts in ann.items():
        mine = sorted(s.start_ns for s in rec.spans if s.name == name)
        for a, b in zip(sorted(starts), mine):
            if b >= t0:  # the first unit's first annotations come late
                clock = max(clock, abs(a - b) / 1e6)
    out = {"window_ms": window_ms, "clock_ms": clock,
           "idle_share": (None if win.spans[0].trace["idle_ms"] is None
                          else 100.0 * win.spans[0].trace["idle_ms"]
                          / window_ms)}

    def named(name):
        return [s for s in inside if s.name == name]

    if args.entry == "train":
        roots = named(STEP)
        out["updates"] = len(roots)
        out["host_ms"] = mean(s.host_ms for s in roots)
        out["host_busy_ms"] = mean(s.host_ms - s.trace["runtime_ms"]
                                   for s in roots)
        out["runtime_ms"] = mean(s.trace["runtime_ms"] for s in roots)
        out["host_syncs"] = mean(s.trace["syncs"] for s in roots)
        out["gae_launches"] = mean(s.trace["launches"]
                                   for s in named(f"{STEP}.gae"))
        kids = [s for s in inside if s.name.startswith(STEP + ".")]
        out["phase_cover"] = (100.0 * sum(s.host_ms for s in kids)
                              / sum(s.host_ms for s in roots))
        out["device_ms"] = mean(s.device_ms for s in roots)
        for p in PHASES:
            ss = named(f"{STEP}.{p}")
            out[p] = {"host_ms": mean(s.host_ms for s in ss),
                      "device_ms": mean(s.device_ms for s in ss),
                      "launches": mean(s.trace["launches"] for s in ss),
                      "runtime_ms": mean(s.trace["runtime_ms"] for s in ss)}
        return out
    roots = named(EVAL)
    out["calls"] = len(roots)
    out["host_ms"] = mean(s.host_ms for s in roots)
    out["eval_setup_ms"] = mean(
        sum(s.host_ms for s in inside if s.parent == r.id
            and s.name in {f"{EVAL}.{p}" for p in SETUP[:3]})
        for r in roots)
    if out["idle_share"] is not None:
        out["setup_idle_share"] = 100.0 * sum(
            s.trace["idle_ms"] for s in inside
            if s.name in {f"{EVAL}.{p}" for p in SETUP}) / window_ms
    out["init_batch_launches"] = mean(s.trace["launches"]
                                      for s in named(f"{EVAL}.init_batch"))
    out["host_syncs"] = mean(s.trace["syncs"] for s in roots)
    for p in EVAL_PHASES:
        ss = named(f"{EVAL}.{p}")
        out[p] = {"host_ms": mean(s.host_ms for s in ss),
                  "idle_ms": (None if out["idle_share"] is None else
                              mean(s.trace["idle_ms"] for s in ss)),
                  "launches": mean(s.trace["launches"] for s in ss),
                  "syncs": mean(s.trace["syncs"] for s in ss)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("entry", choices=("train", "eval"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--episodes", type=int, default=65536)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("span_pass: no CUDA device (--device cpu rehearses)",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    cfg = Config.from_toml(args.config).with_overrides(
        [f"run.seed={args.seed}", *args.overrides])
    unit = units(args, cfg, dev)
    for _ in range(2):  # every shape built and warm
        float(unit())
    sync(dev)
    res = {"config": args.config, "entry": args.entry, "seed": args.seed,
           "card": power_limit() if dev.type == "cuda" else "cpu"}
    unit_ms = {False: [], True: []}
    for record in (False, True, True, False):
        got = window(unit, args.seconds, record, dev)
        unit_ms[record].append((got[2] - got[1]) / 1e6 / got[3])
        if record:
            chrome, t0, t1, n, rec = got
    res["unit_ms_off"], res["unit_ms_on"] = unit_ms[False], unit_ms[True]
    res["units_on"] = n
    res["recording_cost"] = mean(unit_ms[True]) / mean(unit_ms[False]) - 1.0
    res.update(read(args, chrome, t0, t1, rec))
    if args.entry == "train":
        res["synced"] = synced(unit, args.seconds, dev)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "trace.json").write_text(json.dumps(chrome))
        rec.export(out / "spans.jsonl")
    print(json.dumps({k: (None if isinstance(v, float) and not math.isfinite(v)
                          else v) for k, v in res.items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
