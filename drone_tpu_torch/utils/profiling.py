"""Profiling / tracing harness (counterpart of `drone_tpu/utils/profiling.py`).

torch.profiler traces over the host and the card, viewable in Perfetto or
chrome://tracing, a timing helper for bench code that waits for the card,
and the named wall-clock sections of the reference's dashboard.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the host and the card: `with trace('/tmp/t'):
    step()` writes `<logdir>/trace.json` (the reference's xprof_trace)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(logdir) / "trace.json"))


def _leaves(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _leaves(v)


def _wait(out):
    """Wait for the card when an output of `out` lies on it: the call
    returns before the card finishes its work."""
    for leaf in _leaves(out):
        if leaf.device.type == "cuda":
            torch.cuda.synchronize(leaf.device)
            return


def timed(fn, *args, iters: int = 10, warmup: int = 2):
    """Wall-clock fn with the card synchronized after the warm-up and after
    the timed calls. Returns (mean_s, out)."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _wait(out)
    return (time.perf_counter() - t0) / iters, out


class SectionTimers:
    """Named wall-clock sections (the reference's dashboard counters)."""

    def __init__(self):
        self.totals = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def summary(self) -> dict:
        total = sum(self.totals.values()) or 1.0
        return {k: {"s": round(v, 3), "pct": round(100 * v / total, 1)}
                for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])}
