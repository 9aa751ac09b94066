"""Profiling / tracing harness (counterpart of `drone_tpu/utils/profiling.py`).

One recorder of named spans, and torch.profiler traces over the host and
the card, viewable in Perfetto or chrome://tracing.

The program marks its phases with `span(name)` (and the trainers with
`phases(on_phase)`). With recording off, as in every run that is not
asked to record, `span` returns one shared no-op context: it allocates
nothing and reads no clock. `with recording() as rec:` turns recording on
for the process. Each span then holds its name, its parent, its unit (one
per root span: a train step, an evaluate call), its host start and end in
integer nanoseconds on the Unix-epoch clock that torch.profiler's chrome
trace uses (`ts` in microseconds + `baseTimeNanoseconds`), and, once CUDA
is in use, a CUDA event at each end, read into the span's device
milliseconds as recording ends. While a profiler runs, each span also
enters `record_function(name)`, so the trace shows the program's phases
over its kernels; `Record.read_trace` then reads, under each span, what
the trace holds: the launches and syncs its host time made, the host's
time inside CUDA calls, the device's idle time. The spans stay in memory
until `Record.export` writes them.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

ROOT_STEP = "drone.train_step"
# the device ops of a chrome trace, and the host's CUDA calls
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# calls that wait for the device besides the *Synchronize ones
BLOCKING_COPIES = ("cudaMemcpy", "cudaMemcpy2D", "cuMemcpy", "cuMemcpyDtoH",
                   "cuMemcpyDtoH_v2", "cuMemcpyHtoD", "cuMemcpyHtoD_v2")

_OFF = contextlib.nullcontext()
_recording = None  # the Record of `recording()`, None while it is off


class Span:
    """One recorded span; `device_ms` is None until recording ends (and
    without CUDA). `read_trace` adds `launches`, `syncs`, `runtime_ms`
    and `idle_ms`."""

    __slots__ = ("id", "name", "parent", "unit", "start_ns", "end_ns",
                 "device_ms", "trace", "_events", "_annotation")

    def __init__(self, id, name, parent, unit, start_ns):
        self.id, self.name, self.parent, self.unit = id, name, parent, unit
        self.start_ns, self.end_ns = start_ns, None
        self.device_ms, self.trace = None, {}
        self._events, self._annotation = [], None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "parent": self.parent,
                "unit": self.unit, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "device_ms": self.device_ms,
                **self.trace}


def _event():
    """A CUDA event recorded on the current stream, or None before CUDA is
    in use."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Section:
    __slots__ = ("rec", "name", "span")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.span = self.rec.open(self.name)
        return self.span

    def __exit__(self, *exc):
        self.rec.close(self.span)


class Record:
    """The spans of a recording, in the order they opened, and each name's
    host seconds (`totals`, the reference's dashboard sections)."""

    def __init__(self):
        self.spans = []
        self.totals = {}
        self._stack = []
        self._units = 0

    def section(self, name: str):
        """A context that records a span `name` in this record, nested in
        the span open at its start."""
        return _Section(self, name)

    def open(self, name: str, t_ns: int | None = None, event=None) -> Span:
        """Open a span under the innermost open one (a new unit when none
        is open). t_ns and event: the clock reading and CUDA event to start
        it at (a mark that closes one span and opens the next shares
        them)."""
        parent = self._stack[-1] if self._stack else None
        if parent is None:
            self._units += 1
        span = Span(len(self.spans), name,
                    None if parent is None else parent.id,
                    self._units if parent is None else parent.unit,
                    time.time_ns() if t_ns is None else t_ns)
        span._events.append(_event() if event is None else event)
        if _autograd_profiler._is_profiler_enabled:
            span._annotation = torch.profiler.record_function(name)
            span._annotation.__enter__()
        self.spans.append(span)
        self._stack.append(span)
        return span

    def close(self, span: Span, t_ns: int | None = None, event=None):
        """Close `span` and every span opened inside it still open."""
        if span.end_ns is not None:
            return
        while self._stack:
            top = self._stack.pop()
            if top._annotation is not None:
                top._annotation.__exit__(None, None, None)
                top._annotation = None
            top._events.append(_event() if event is None else event)
            top.end_ns = time.time_ns() if t_ns is None else t_ns
            self.totals[top.name] = (self.totals.get(top.name, 0.0)
                                     + (top.end_ns - top.start_ns) / 1e9)
            if top is span:
                break

    def finish(self):
        """Close what is still open, wait for the card and read each
        span's device milliseconds from its CUDA events."""
        if self._stack:
            self.close(self._stack[0])
        if any(e is not None for s in self.spans for e in s._events):
            torch.cuda.synchronize()
        for s in self.spans:
            e0, e1 = (s._events + [None, None])[:2]
            if e0 is not None and e1 is not None:
                s.device_ms = e0.elapsed_time(e1)
            s._events = []

    def summary(self) -> dict:
        """Each span name's host seconds and share of them all, the
        longest first."""
        total = sum(self.totals.values()) or 1.0
        return {k: {"s": round(v, 3), "pct": round(100 * v / total, 1)}
                for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])}

    def read_trace(self, chrome: dict):
        """Read what a chrome trace of torch.profiler (the exported JSON
        object) holds under each closed span, into `span.trace`:
        launches, the kernels, memcpys and memsets whose host call (the
        first with their correlation id) fell inside the span; syncs, its
        host calls that wait for the device (`*Synchronize`, a blocking
        memcpy); runtime_ms, the host's time inside CUDA calls (launch
        back-pressure, waits); idle_ms, the time in it with no device op
        running (None when the trace holds no device op)."""
        base = chrome.get("baseTimeNanoseconds", 0)
        events = [e for e in chrome.get("traceEvents", ())
                  if e.get("ph") == "X"]
        device = [e for e in events if e.get("cat") in DEVICE_CATS]
        calls = [e for e in events if e.get("cat") in RUNTIME_CATS]
        called = {}  # correlation id -> the host call's start
        for e in calls:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                called[c] = min(called.get(c, math.inf), float(e["ts"]))
        launch_ts = sorted(called[c] for c in
                           (e.get("args", {}).get("correlation")
                            for e in device) if c in called)
        sync_ts = sorted(float(e["ts"]) for e in calls
                         if "Synchronize" in e["name"]
                         or e["name"] in BLOCKING_COPIES)
        runtime = _Cover(calls)
        busy = _Cover(device) if device else None
        for s in self.spans:
            if s.end_ns is None:
                continue
            a, b = (s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3
            s.trace = {
                "launches": _count(launch_ts, a, b),
                "syncs": _count(sync_ts, a, b),
                "runtime_ms": runtime.within(a, b) / 1e3,
                "idle_ms": (None if busy is None
                            else (b - a - busy.within(a, b)) / 1e3)}

    def export(self, path):
        """Write one JSON line a span (`Span.as_dict`)."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            for s in self.spans:
                f.write(json.dumps(s.as_dict()) + "\n")


# the reference's name for its dashboard sections
SectionTimers = Record


class _Cover:
    """The union of the [ts, ts + dur) intervals of chrome-trace events,
    and its length inside any interval (microseconds)."""

    def __init__(self, events):
        merged = []
        for a, b in sorted((float(e["ts"]), float(e["ts"])
                            + float(e.get("dur", 0.0))) for e in events):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.starts = [m[0] for m in merged]
        self.ends = [m[1] for m in merged]
        self.before = [0.0]  # covered length before each merged interval
        for a, b in merged:
            self.before.append(self.before[-1] + b - a)

    def _upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        return (self.before[i - 1] + min(self.ends[i - 1], t)
                - self.starts[i - 1])

    def within(self, a: float, b: float) -> float:
        return max(0.0, self._upto(b) - self._upto(a))


def _count(ts: list, a: float, b: float) -> int:
    return bisect.bisect_left(ts, b) - bisect.bisect_left(ts, a)


def span(name: str):
    """A context recording a span `name` while recording is on; the shared
    no-op context otherwise."""
    rec = _recording
    if rec is None:
        return _OFF
    return rec.section(name)


@contextlib.contextmanager
def recording():
    """Turn recording on for the process: `with recording() as rec:`. On
    leaving, open spans are closed and device times read (a wait for the
    card)."""
    global _recording
    if _recording is not None:
        raise RuntimeError("spans are already being recorded")
    rec = Record()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None
        rec.finish()


def phases(on_phase=None):
    """A train step's phase marker: mark(name) for "rollout", "gae",
    "update", "metrics" and "end", in that order, calls on_phase(name) as
    it comes. While recording, "rollout" opens a `drone.train_step` span
    and each mark closes the previous phase's span and opens
    `drone.train_step.<name>` at the same instant, "end" closing the
    step."""
    opened = []  # [record, step span, phase span] of the step being marked

    def mark(name):
        if opened or _recording is not None:
            _mark(opened, name)
        if on_phase is not None:
            on_phase(name)

    return mark


def _mark(opened: list, name: str):
    rec = _recording
    if opened and opened[0] is not rec:  # recording ended inside the step
        opened.clear()
        if rec is None:
            return
    t, ev = time.time_ns(), _event()
    if opened and name in ("rollout", "end"):
        # "rollout" with a step still open: that step raised
        opened[0].close(opened[1], t, ev)
        opened.clear()
    elif opened:
        opened[0].close(opened[2], t, ev)
        opened[2] = opened[0].open(f"{ROOT_STEP}.{name}", t, ev)
    if name == "rollout" and rec is not None:
        root = rec.open(ROOT_STEP, t, ev)
        opened[:] = [rec, root, rec.open(f"{ROOT_STEP}.rollout", t, ev)]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace of the host and the card with the program's spans:
    `with trace('/tmp/t'): step()` writes `<logdir>/trace.json` (the
    reference's xprof_trace) and `<logdir>/spans.jsonl`, the spans
    recorded meanwhile with what the trace holds under each."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    path = Path(logdir) / "trace.json"
    with recording() as rec:
        with profile(activities=activities) as prof:
            yield prof
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        rec.read_trace(json.load(f))
    rec.export(Path(logdir) / "spans.jsonl")
