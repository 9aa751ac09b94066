"""Readings that the limits of `correct` are set from, at a cell's own size.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 ... \
        [--controls 3] [--faults]

For every seed, the number(s) a run compares, read of the program's
output against the plain reference: the lower readings. For the first
`--controls` seeds, the same numbers read of the control, the reference
put in the program's place with its products in TF32 (the precision below
the configurations' float32): the upper readings. With --faults, the
planted faults' readings on the same seeds: the reference put in the
program's place with half of every minibatch left out (training), or with
half of the lanes (evaluation). One JSON line a reading on standard
output. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402


def context(cell: str, seed: int, device, log=None):
    """The context a run of `cell` hands its entry (no window)."""
    from benchmark.harness import spec as S

    bench = S.load_spec()
    c = S.cell(bench, cell)
    wl = S.workload_file(cell)
    tables = S.config_tables(S.ROOT / S.config_entry(bench, c["config"])["file"])
    kernels, step = S.counts(c["config"]).counts(tables, wl)
    peaks = S.peaks()
    return SimpleNamespace(
        name=cell, workload=wl, tables=tables, seed=seed, seconds=0.0,
        trace=False, device=device, t0=T0, kernels=kernels, step=step,
        peak_flops=peaks["flops"]["float32"],
        peak_bytes_per_s=peaks["hbm_bytes_per_s"],
        log=log or (lambda m: print(m, file=sys.stderr, flush=True)))


def train_readings(ctx, control: bool, faults: bool) -> list:
    from benchmark.entries import train as E

    st = E.start(ctx)
    sd, prog = st["sd"], st["prog"]
    del st
    E.free(ctx.device)
    ref = E.reference(ctx, sd)
    out = [("program", E.gaps(sd, prog, ref))]
    if control:
        out.append(("control_tf32", E.gaps(sd, E.reference(ctx, sd, "tf32"),
                                           ref)))
    if faults:
        out.append(("fault_half_batch",
                    E.gaps(sd, E.reference(ctx, sd, half_batch=True), ref)))
        out.append(("fault_unchanged",
                    E.gaps(sd, E.reference(ctx, sd, frozen=True), ref)))
    return out


def eval_readings(ctx, control: bool, faults: bool) -> list:
    import dataclasses
    from types import SimpleNamespace as NS

    from drone_tpu_torch import train as T

    from benchmark.entries import eval as E
    from benchmark.harness import program, weights
    from benchmark.reference import nets

    wl = ctx.workload
    program.build_sources(wl["sources"], ctx.device)
    cfg = program.config(ctx.tables, ctx.seed)
    sd = weights.make(nets.param_shapes(ctx.tables["run"]), ctx.seed,
                      ctx.device)
    c1 = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                          seed=ctx.seed + 1))
    with E.Lanes(want=1) as rec:
        answer = T.evaluate(c1, NS(params=sd), episodes=int(wl["episodes"]),
                            deterministic=True, device=ctx.device)
    ref = E.reference(ctx, sd, 1)
    out = [("program", E.gaps((answer, rec.kept), ref))]
    if control:
        st, acc, fin = E.reference(ctx, sd, 1, "tf32")
        out.append(("control_tf32", E.gaps((st, (_State(fin),
                                                  _lane_rows(acc))), ref)))
    if faults:
        half = int(wl["episodes"]) // 2
        st, acc, fin = E.reference(ctx, sd, 1, episodes=half)
        out.append(("fault_half_lanes", E.gaps((st, (_State(fin),
                                                      _lane_rows(acc))), ref)))
    return out


class _State:
    """A reference's final state where the program's is read (`.pos`)."""

    def __init__(self, s):
        self.pos = s["pos"]


def _lane_rows(acc):
    """The reference's per-lane sums (episodes, return, return squared,
    length) in the program's rows (reward, episodes, return, length, return
    squared)."""
    import torch

    return torch.stack([torch.zeros_like(acc[0]), acc[0], acc[1], acc[3],
                        acc[2]])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=0)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    dev = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        ctx = context(args.workload, seed, dev)
        read = (train_readings if ctx.workload["entry"] == "train"
                else eval_readings)
        t = time.perf_counter()
        for kind, vals in read(ctx, i < args.controls,
                               args.faults and i < args.controls):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, **vals}), flush=True)
        print(f"seed {seed}: {time.perf_counter() - t:.1f} s",
              file=sys.stderr, flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
