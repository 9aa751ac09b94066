"""What a run reads: BENCHMARK.json at the root of the checkout, the cell's
workload file, its configuration's file, and the files found by name
beside them (entries, counts, metric readers).

Adding a configuration, a traffic mix or a per-layer metric adds files and
entries only: nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import tomllib
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent   # benchmark/
ROOT = BENCH.parent                              # the checkout


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    """The `workloads` entry named `name`; KeyError names the known ones."""
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in spec['workloads']]}")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def workload_file(name: str, bench: Path = BENCH) -> dict:
    """benchmark/workloads/<cell>.json: the entry, its traffic and the
    limits of its correctness checks."""
    return json.loads((bench / "workloads" / f"{name}.json").read_text())


def config_tables(path: Path) -> dict:
    """A configuration file (TOML in the repo's schema, plus a [benchmark]
    table of its source, departures and precision)."""
    with open(path, "rb") as f:
        return tomllib.load(f)


def reports(metric: dict, workload: str, spec: dict) -> bool:
    """Whether the cell `workload` reports `metric`: its own list when it
    has one, else every cell that reports the end-to-end metric it moves
    (or every cell, for an end-to-end metric)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    moves = metric.get("moves")
    if moves is None:
        return True
    e2e = next(m for m in spec["end_to_end"] if m["name"] == moves)
    return reports(e2e, workload, spec)


def entry(name: str):
    """benchmark/entries/<name>.py: the driver of a kind of cell."""
    return importlib.import_module(f"benchmark.entries.{name}")


def counts(config: str, bench: Path = BENCH):
    """benchmark/counts/<config>.py: products and bytes from shapes."""
    return _load(bench / "counts" / f"{config}.py", f"counts_{config}")


def reader(metric: str, bench: Path = BENCH):
    """benchmark/metrics/<metric>.py: the reader of one per-layer metric."""
    return _load(bench / "metrics" / f"{metric}.py", f"metric_{metric}")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks(bench: Path = BENCH) -> dict:
    return json.loads((bench / "harness" / "peaks.json").read_text())
