"""Batch-geometry autotuner: measure train-SPS over candidate shapes
(counterpart of `drone_tpu/autotune.py`).

The knobs that set a training run's throughput and that a user can act on
are `train.num_envs` (the lanes the trainers tile over) and
`train.num_minibatches` (the update kernels' minibatch geometry); the
kernels pick their own block shapes. Each candidate is measured on the
trainer `train.build` picks for it (`train.trainer_kind`: the megakernel
trainer where its kernels take the shape, the scan or hybrid tier
otherwise), so the measurement is the production path. Every timed region
ends with a value read of the loss.

One change from the reference: it keeps a shape by a 1,024-lane rule on a
TPU and a 128-lane rule on its CPU backend; the port's megakernel trainers
take 128-lane rows on every device, so the port's candidate list is the one
the reference builds on its CPU backend.

Changing num_envs changes learning dynamics; the tool reports throughput
and leaves the choice to the user.
"""

from __future__ import annotations

import dataclasses
import time

from drone_tpu_torch.parallel.mesh import world_size

LANE_ROW = 128  # the megakernel trainers' lanes a row


def candidate_shapes(cfg, max_envs: int = 1 << 20):
    """Candidate (num_envs, num_minibatches) pairs around the config's.

    num_envs sweeps powers-of-two scalings of the current value (x1/4 ..
    x4); num_minibatches sweeps {2, 4, 8} plus the current. Shapes are kept
    when a rank's lanes (train.build divides num_envs over the process
    group's ranks before the trainers see it) split into num_minibatches
    of whole 128-lane rows, the megakernel trainers' rule, OR the shape
    equals the current config (the baseline is always measured, even if it
    only reaches the scan trainer)."""
    n_dev = world_size()
    cur = (cfg.train.num_envs, cfg.train.num_minibatches)
    envs_c = sorted({max(cfg.train.num_envs >> s, LANE_ROW)
                     for s in (2, 1, 0)}
                    | {min(cfg.train.num_envs << s, max_envs)
                       for s in (1, 2)})
    mbs_c = sorted({2, 4, 8, cfg.train.num_minibatches})
    # the baseline goes in unconditionally: the scaled set clamps to
    # LANE_ROW, so a current num_envs below it never reappears in the loop
    out = [cur]
    for n in envs_c:
        for mb in mbs_c:
            if (n, mb) == cur:
                continue
            use_mesh = cfg.run.mesh and n_dev > 1 and n % n_dev == 0
            local = n // n_dev if use_mesh else n
            if local % (LANE_ROW * mb) == 0:
                out.append((n, mb))
    return out


def _with_shape(cfg, num_envs: int, num_minibatches: int):
    return dataclasses.replace(
        cfg, train=dataclasses.replace(
            cfg.train, num_envs=num_envs, num_minibatches=num_minibatches))


def measure_train_sps(cfg, iters: int = 3,
                      device="cuda") -> tuple[float, str]:
    """Build the production train step for cfg (train.build's selection)
    on `device` and measure samples/s over `iters` updates after one
    warm-up. Returns (sps, trainer label: "megakernel" or
    "scan/hybrid")."""
    from drone_tpu_torch.train import build

    env, model, runner, step, cfg = build(cfg, device)
    label = "megakernel" if step.kind == "megakernel" else "scan/hybrid"
    runner, m = step(runner)          # warm-up
    float(m["loss"])
    t0 = time.perf_counter()
    for _ in range(iters):
        runner, m = step(runner)
    float(m["loss"])                  # a value read: the card has finished
    dt = time.perf_counter() - t0
    return cfg.train.num_envs * cfg.train.horizon * iters / dt, label


def autotune(cfg, iters: int = 3, candidates=None, measure_fn=None,
             verbose: bool = True, device="cuda"):
    """Measure every candidate shape on `device`; return results sorted
    best-first.

    Each result: {"num_envs", "num_minibatches", "sps", "trainer",
    "overrides"} where overrides is the dotted-CLI string reproducing the
    shape. candidates/measure_fn are injectable for tests. A candidate that
    raises (out of memory, a shape a trainer refuses) is reported and
    skipped."""
    if candidates is None:
        candidates = candidate_shapes(cfg)
    if measure_fn is None:
        def measure_fn(c):
            return measure_train_sps(c, iters=iters, device=device)
    results = []
    for n, mb in candidates:
        trial = _with_shape(cfg, n, mb)
        try:
            sps, label = measure_fn(trial)
        except Exception as e:  # out of memory / shape refused: go on
            if verbose:
                print(f"[autotune] num_envs={n} num_minibatches={mb}: "
                      f"failed ({e!r:.120})", flush=True)
            continue
        rec = {
            "num_envs": n,
            "num_minibatches": mb,
            "sps": round(sps, 1),
            "trainer": label,
            "overrides": f"train.num_envs={n} train.num_minibatches={mb}",
        }
        results.append(rec)
        if verbose:
            print(f"[autotune] num_envs={n} num_minibatches={mb}: "
                  f"{sps / 1e6:.2f}M SPS ({label})", flush=True)
    results.sort(key=lambda r: -r["sps"])
    return results
