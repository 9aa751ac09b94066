"""What a per-layer metric's reader sees of a traced run, and the
arithmetic the readers share: a kernel's time a call from the trace, its
share of the roofline, the step's share of the peak."""

from __future__ import annotations

from dataclasses import dataclass, field

from benchmark.harness.trace import Trace


@dataclass
class View:
    """entry: "train" or "eval"; trace: the profiled window (None when
    the profiler recorded nothing); phases: device milliseconds of each
    phase of the trainer, one list entry an update; host_queue_s: the host
    clock of each step call of the window; kernels: the products and
    bytes of each kernel a call, and step: of the whole step a unit of work
    (counts/<config>.py); peak_flops, peak_bytes_per_s: the chip's;
    unit_work: the samples (train) or env steps (eval) of one unit."""

    entry: str
    trace: Trace | None
    kernels: dict
    step: dict
    peak_flops: float
    peak_bytes_per_s: float
    unit_work: int
    phases: dict = field(default_factory=dict)
    host_queue_s: list = field(default_factory=list)

    def call_seconds(self, anchor: str, own=(), shared=()) -> float | None:
        """A kernel's device seconds a call: its own kernels' time over
        the launches of `anchor` (launched once a call), plus the mean
        launch of each kernel it shares with another (launched once a call
        of each). None when the trace holds no launch of `anchor`."""
        if self.trace is None:
            return None
        t, calls = self.trace.total(anchor)
        if calls == 0:
            return None
        for name in own:
            t += self.trace.total(name)[0]
        sec = t / calls
        for name in shared:
            s, n = self.trace.total(name)
            if n:
                sec += s / n
        return sec

    def roofline(self, kernel: str, anchor: str, own=(), shared=()):
        """100 x the least time of one call (its products over the peak, or
        its bytes over the memory's rate, whichever is longer) over its
        mean time a call in the trace, in %."""
        sec = self.call_seconds(anchor, own, shared)
        work = self.kernels.get(kernel)
        if sec is None or not work or sec <= 0:
            return None
        least = max(work["flops"] / self.peak_flops,
                    work["bytes"] / self.peak_bytes_per_s)
        return 100.0 * least / sec

    def mfu(self) -> float | None:
        """100 x the model FLOPs of the traced window's work over the peak
        for its length."""
        if self.trace is None or self.trace.window_s <= 0:
            return None
        flops = self.step[self.entry] * self.unit_work * self.trace.units
        return 100.0 * flops / self.trace.window_s / self.peak_flops

    def idle_share(self) -> float | None:
        if self.trace is None or self.trace.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.window_s)

    def phase_ms(self, name: str) -> float | None:
        vals = self.phases.get(name)
        return sum(vals) / len(vals) if vals else None
