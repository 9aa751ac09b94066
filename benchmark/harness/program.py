"""The program under test as the entries drive it: its config from a
configuration's tables, its CUDA sources built before the warm-up, the
comparisons of its outputs with the reference's."""

from __future__ import annotations

import math
import statistics
import time

PROGRAM_TABLES = ("run", "env", "train")


def config(tables: dict, seed: int):
    """The program's Config of a configuration's tables, run.seed the
    run's seed."""
    from drone_tpu_torch.utils.config import Config

    data = {k: dict(tables[k]) for k in PROGRAM_TABLES if k in tables}
    data["run"]["seed"] = int(seed)
    return Config.from_dict(data)


def build_sources(names, device) -> float:
    """Build the cell's CUDA sources (all nvcc processes at once; a library
    already in the checkout's build directory is loaded, not rebuilt).
    Returns the seconds it took."""
    if device.type != "cuda":
        return 0.0
    from drone_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build(tuple(names))
    return time.perf_counter() - t0


def rel(a: float, b: float, floor: float = 0.0) -> float:
    """|a - b| over max(|b|, floor); inf when a is not finite."""
    if not math.isfinite(a):
        return math.inf
    return abs(a - b) / max(abs(b), floor, 1e-30)


def worst_leaf(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap of norms: max over leaves of | |p| - |r| |
    over max(|r|, the median leaf's |r|). keep: the leaves compared
    (default all)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(ref[k].double().norm()) for k in names}
    med = statistics.median(rn.values())
    worst = 0.0
    for k in names:
        pn = float(prog[k].double().norm())
        if not math.isfinite(pn):
            return math.inf
        worst = max(worst, abs(pn - rn[k]) / max(rn[k], med, 1e-30))
    return worst


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (q in (0, 100])."""
    v = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(v)))
    return v[k - 1]
