"""The device trace of a steady window: torch.profiler over a run of
updates or calls, read into device busy time, each kernel's time and
launches, and the host's activity in the device's idle gaps.

The window is a `record_function` range that opens after one unit has run
under the profiler, so a first kernel the profiler would miss falls
outside it; it closes after a value read, so every kernel it queued ran
inside it. The chrome trace is written under TMPDIR, read and deleted.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

WINDOW = "bench_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


@dataclass
class Trace:
    """A traced window: its length, the device's busy time, each device
    op's (seconds, launches) by name, the idle gaps' seconds by what the
    host was doing, and the units (updates or calls) it held."""

    window_s: float
    busy_s: float
    ops: dict = field(default_factory=dict)
    gaps: dict = field(default_factory=dict)
    units: int = 0

    def total(self, name: str) -> tuple[float, int]:
        """(seconds, launches) of every device op whose name holds `name`."""
        s, n = 0.0, 0
        for op, (sec, cnt) in self.ops.items():
            if name in op:
                s += sec
                n += cnt
        return s, n

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v[0]] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def record(unit, seconds: float, min_units: int = 3) -> Trace:
    """Run unit() under torch.profiler: once, then inside the window until
    `seconds` have passed and at least min_units ran. unit() returns a
    tensor whose read ends the window. Raises RuntimeError when the
    profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    tmp = tempfile.NamedTemporaryFile(suffix=".json", delete=False,
                                      dir=os.environ.get("TMPDIR"))
    tmp.close()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            float(unit())
            torch.cuda.synchronize()
            n = 0
            with record_function(WINDOW):
                t0 = time.perf_counter()
                while n < min_units or time.perf_counter() - t0 < seconds:
                    out = unit()
                    n += 1
                float(out)
        prof.export_chrome_trace(tmp.name)
        with open(tmp.name) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(tmp.name)
    trace = parse(events)
    trace.units = n
    return trace


def parse(events: list) -> Trace:
    """Trace of the chrome-trace events inside the WINDOW range."""
    span = [e for e in events if e.get("name") == WINDOW
            and e.get("cat") == "user_annotation"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not span or not device:
        raise RuntimeError("the trace holds no window or no device activity")
    t0 = float(span[0]["ts"])
    t1 = t0 + float(span[0]["dur"])
    ops: dict = {}
    intervals = []
    for e in device:
        a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        intervals.append((a, b))
        sec, cnt = ops.get(e["name"], (0.0, 0))
        ops[e["name"]] = (sec + (b - a) / 1e6, cnt + 1)
    intervals.sort()
    busy, gaps, end = 0.0, [], t0
    for a, b in intervals:
        if a > end:
            gaps.append((end, a))
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    if end < t1:
        gaps.append((end, t1))
    host = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                   e["name"]) for e in events
                  if e.get("cat") in HOST_CATS and e.get("name") != WINDOW
                  and e.get("ph") == "X")
    starts = [h[0] for h in host]
    by_host: dict = {}
    for a, b in gaps:
        label = _host_at((a + b) / 2, host, starts)
        by_host[label] = by_host.get(label, 0.0) + (b - a) / 1e6
    return Trace(window_s=(t1 - t0) / 1e6, busy_s=busy / 1e6, ops=ops,
                 gaps=by_host)


def _host_at(t: float, host: list, starts: list) -> str:
    """The innermost host op running at time t (the shortest that covers
    it, among those that started in the last second)."""
    i = bisect.bisect_right(starts, t)
    best = None
    for a, b, name in reversed(host[max(0, i - 4000):i]):
        if a < t - 1e6:
            break
        if b >= t and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "host: between ops"
