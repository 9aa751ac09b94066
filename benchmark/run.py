"""Run one cell of the benchmark on the machine it is started on.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's entries in BENCHMARK.json and its
workload file (benchmark/workloads/<cell>.json) say what runs: the entry
(benchmark/entries/<entry>.py), the configuration's file, the CUDA
sources to build. The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), `device`, with --trace 1
`breakdown`, and last `checks`, each number compared with its limit. The
same numbers and limits are the last lines of standard error.

Exits 3 without a result when the chips the cell asks for are not there,
4 when the program is not in the checkout, 5 when the process has loaded
JAX or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

# compared by the top-level name of each loaded module
FORBIDDEN = ("jax", "jaxlib", "flax", "drone_tpu", "oracle")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among `names` (default: the loaded
    modules)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import spec as S

    cell = S.cell(S.load_spec(), args.workload)
    # torch's own runtime kernel cache: a fixed directory in the checkout
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                          str(S.ROOT / "build" / "torch_kernels"))

    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < int(cell["chips"])):
        log(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    try:
        import drone_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program is not in this checkout: {e}")
        return 4
    torch.set_num_threads(2)
    code, line = execute(args, torch.device("cuda", 0))
    if line is not None:
        print(line, flush=True)
    return code


def execute(args, dev, adjust=None):
    """Run the cell on `dev`: (exit code, the result's line or None).
    adjust(tables, workload) -> (tables, workload) resizes a run (the CPU
    tests' small sizes)."""
    import torch

    from benchmark.harness import spec as S

    bench = S.load_spec()
    cell = S.cell(bench, args.workload)
    wl = S.workload_file(args.workload)
    conf = S.config_entry(bench, cell["config"])
    tables = S.config_tables(S.ROOT / conf["file"])
    if adjust is not None:
        tables, wl = adjust(tables, wl)
    cuda = dev.type == "cuda"
    precision = tables.get("benchmark", {}).get("precision", "float32")
    peaks = S.peaks()
    kernels, step = S.counts(cell["config"]).counts(tables, wl)
    ctx = SimpleNamespace(
        name=args.workload, workload=wl, tables=tables, seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace), device=dev, t0=T0,
        kernels=kernels, step=step, peak_flops=peaks["flops"][precision],
        peak_bytes_per_s=peaks["hbm_bytes_per_s"], log=log)
    kind = torch.cuda.get_device_name(dev) if cuda else "cpu"
    log(f"{args.workload} seed {args.seed}: {kind}, power limit "
        f"{power_limit() if cuda else 'n/a'}; peak {ctx.peak_flops:.4g} "
        f"FLOP/s ({precision}), {ctx.peak_bytes_per_s:.4g} B/s")

    out = S.entry(wl["entry"]).run(ctx)

    metrics = {}
    if args.trace:
        view = out["view"]
        for m in bench["per_layer"]:
            if S.reports(m, args.workload, bench):
                v = S.reader(m["name"]).read(view)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if S.reports(m, args.workload, bench):
                if m["name"] not in out["e2e"]:
                    log(f"the entry measured no {m['name']}")
                    return 6, None
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": int(cell["chips"]),
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": None, "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics,
              "device": device}
    if args.trace:
        tr = out["view"].trace if out["view"] is not None else None
        if tr is None:
            log("the traced run holds no device trace")
            return 6, None
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    result["compile_s"] = out["compile_s"]
    # the numbers compared are those the workload gives a limit
    missing = set(wl["limits"]) - set(out["checks"])
    if missing:
        log(f"the entry read no {sorted(missing)}")
        return 6, None
    checks = {k: {"value": out["checks"][k], "limit": v}
              for k, v in wl["limits"].items()}
    result["correct"] = all(math.isfinite(c["value"])
                            and c["value"] <= c["limit"]
                            for c in checks.values())
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        log(f"the process loaded {bad}: the benchmark runs without JAX")
        return 5, None
    log(f"compile {out['compile_s']:.3f} s (inside setup_s in a run that "
        f"builds)")
    for k, c in checks.items():
        log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    return 0, json.dumps(result)


if __name__ == "__main__":
    sys.exit(main())
