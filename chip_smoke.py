#!/usr/bin/env python3
"""Smoke test of drone_tpu_torch on one CUDA card: `python3 chip_smoke.py`.

Builds the CUDA kernels from csrc/ (nvcc, in parallel), holds each against
its plain PyTorch version on the card's inputs, drives the port's two paths
through the entry points a user calls, checks what comes out, and times
each kernel beside its plain version and its bound. Exits nonzero, printing
no result, when there is no CUDA device or a phase fails.

Phases:
  1. K1 (csrc/rollout.cu) against its plain version run on the CPU, bitwise
     on every state plane and per-lane statistic: all 6 task x integrator
     pairs, hover/euler at 65,536 lanes (configs/hover.toml's num_envs) and
     the others at 8,192, T = 64, with a provided action stream and with
     the in-kernel one. The plain version on the card must equal the CPU's
     bitwise too: env params are CUDA tensors there (a CPU scalar divisor
     would become a reciprocal multiply).
  2. K5 (csrc/acting.cu) against its plain version on the card,
     deterministic and stochastic: hover, [64, 64], 65,536 lanes, T = 3
     within rtol 2e-5 / atol 2e-6 with episode counts equal, and T = 64
     with episode counts within 2% and mean reward per lane-step within
     0.01; then a [32, 48, 20] tower on waypoint/rk4 and a linear policy on
     racing/euler, 8,192 lanes, T = 3.
  3. The env-engine path: `ops.rollout_cuda` at 65,536 lanes x 1,001 steps
     of in-kernel random actions (hover.toml's env).
  4. The serving path: a seeded ActorCritic([64, 64]) saved with the
     Checkpointer, `train.evaluate(cfg, episodes=65536)` on hover.toml, and
     `cli eval` at its default size. Launch counts are zeroed just before
     each path and read just after; each path must have run its kernel.
  5. evaluate() on the card against evaluate() on the CPU (plain versions)
     at 512 episodes: episode counts within 1%, mean return within 1%.
  6. Times by CUDA events after a warm-up, at the paths' shapes.

The second-to-last line is the kernels JSON, the last the device JSON.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The card's peaks used for bound_ms (NVIDIA H100 SXM data sheet, dense):
# 3.35 TB/s of HBM, 67 TFLOP/s float32 outside the tensor cores. Integer
# ops are counted at the same rate; an H100 issues them no faster, so the
# bound stays a lower bound on the time.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Operations of the hover/euler paths, counted from csrc/env.cuh and the
# kernels (one op per add, mul, div, sqrt, compare, select, shift, xor or
# rotate; a multiply-add counts 2). A threefry block is 79 integer ops (2
# key adds, 20 rounds of add/rotate/xor, 5 key injections of 3 adds, the
# parity word), a uniform 3 more.
_TF, _UNI = 79, 3
# every lane-step: mix 25, euler deriv + update 119, normalize 12, reward 33,
# termination 20, state select 25, statistics 9
OPS_STEP = 243
# a reset, needed only by lanes that ended an episode: 7 blocks + init_pose
OPS_RESET = 7 * (_TF + 2 * _UNI) + 60
OPS_RANDOM_ACTIONS = 2 + 2 * _TF + 4 * (_UNI + 2)
OPS_OBS = 3


def tower_ops(hidden) -> int:
    """Multiply-adds x2 + bias adds + one per tanh of an actor tower."""
    dims = [13, *hidden, 4]
    macs = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    return 2 * macs + sum(dims[1:]) + sum(hidden)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bitwise_equal(a, b) -> bool:
    import torch

    a, b = a.contiguous().cpu(), b.contiguous().cpu()
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def planes(state, lane_stats):
    from drone_tpu_torch.ops import cuda_rollout

    return [*cuda_rollout.pack_state(state), lane_stats]


def cuda_ms(fn, reps: int) -> float:
    """Mean time of `fn` over `reps` back-to-back calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def phase_k1():
    """K1 against its plain version; returns the largest difference (0.0)."""
    import torch

    from drone_tpu_torch import prng
    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_rollout
    from drone_tpu_torch.types import default_params

    T = 64
    for task in ("hover", "waypoint", "racing"):
        for integ in ("euler", "rk4"):
            n = 65536 if (task, integ) == ("hover", "euler") else 8192
            # short horizon and a wide reach radius so auto-resets and
            # waypoint/gate progression fire; domain randomization on
            over = dict(horizon=40, dr_mass_lo=0.8, dr_mass_hi=1.2,
                        dr_thrust_lo=0.9, dr_thrust_hi=1.1)
            if task != "hover":
                over["reach_tol2"] = 4.0
            env = DroneEnv(task, integ, default_params(task, **over),
                           device="cuda")
            state = env.init_batch(11, n)
            stream = torch.from_numpy(
                prng.action_stream_np(T, n, seed=3, scale=0.9, bias=0.05))
            plain_provided = None
            for mode, acts in (("provided", stream), ("in-kernel", None)):
                k_state, k_stats = cuda_rollout.rollout_kernel(
                    state, env.params, env.statics, T,
                    None if acts is None else acts.cuda())
                torch.cuda.synchronize()
                plain = planes(*cuda_rollout.rollout_plain(
                    state.to("cpu"), env.params.to("cpu"), env.statics, T,
                    acts))
                ok = all(bitwise_equal(a, b) for a, b in
                         zip(planes(k_state, k_stats), plain))
                episodes = float(k_stats[1].sum())
                print(f"K1 {task}/{integ} n={n} T={T} {mode} actions: "
                      f"bitwise={ok} episodes={episodes:.0f}", flush=True)
                if not ok:
                    raise AssertionError(f"K1 differs from its plain version "
                                         f"({task}/{integ}, {mode})")
                if episodes < n:
                    raise AssertionError("K1 check exercised no resets")
                if acts is not None:
                    plain_provided = plain
            on_card = planes(*cuda_rollout.rollout_plain(
                state, env.params, env.statics, T, stream.cuda()))
            ok = all(bitwise_equal(a, b)
                     for a, b in zip(on_card, plain_provided))
            print(f"plain env on the card == on the CPU ({task}/{integ}): "
                  f"{ok}", flush=True)
            if not ok:
                raise AssertionError("the plain env differs between the card "
                                     "and the CPU")
    return 0.0


def seeded_policy(hidden=(64, 64), seed=0, head_gain=None):
    import torch
    from torch import nn

    from drone_tpu_torch.models import ActorCritic

    g = torch.Generator().manual_seed(seed)
    m = ActorCritic(hidden, generator=g)
    if head_gain is not None:
        # actions of order 1, so the comparison exercises the tower
        nn.init.orthogonal_(m.actor_mean.weight, head_gain, generator=g)
    return m


def phase_k5() -> float:
    """K5 against its plain version on the card; returns the max abs error
    of the T = 3 final states."""
    import torch

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_acting
    from drone_tpu_torch.types import default_params

    # the main path's tower at its width, then a depth-3 tower of odd widths
    # (ping-pong activation buffers, padded chunks) and a linear policy on
    # the other task templates
    cases = [("hover", "euler", (64, 64), 65536, ((3, 2), (64, 40))),
             ("waypoint", "rk4", (32, 48, 20), 8192, ((3, 2),)),
             ("racing", "euler", (), 8192, ((3, 2),))]
    max_err = 0.0
    for task, integ, hidden, n, runs in cases:
        policy = seeded_policy(hidden, head_gain=1.0).cuda()
        for T, horizon in runs:
            env = DroneEnv(task, integ, default_params(task, horizon=horizon),
                           device="cuda")
            state = env.init_batch(2, n)
            for sto in (False, True):
                kf, ks = cuda_acting.act_rollout_kernel(
                    state, policy, env.params, env.statics, T, sto)
                pf, ps = cuda_acting.act_rollout_plain(
                    state, policy, env.params, env.statics, T, sto)
                torch.cuda.synchronize()
                k_ep, p_ep = float(ks[1].sum()), float(ps[1].sum())
                k_r = float(ks[0].sum()) / (n * T)
                p_r = float(ps[0].sum()) / (n * T)
                err = float((kf.fstate() - pf.fstate()).abs().max())
                print(f"K5 {task}/{integ} {list(hidden)} n={n} T={T} "
                      f"stochastic={sto}: max|state err|={err:.3g} episodes "
                      f"{k_ep:.0f} vs {p_ep:.0f}, mean reward {k_r:.6f} vs "
                      f"{p_r:.6f}", flush=True)
                if T == 3:
                    max_err = max(max_err, err)
                    torch.testing.assert_close(kf.fstate(), pf.fstate(),
                                               rtol=2e-5, atol=2e-6)
                    if k_ep != p_ep or k_ep < n:
                        raise AssertionError("K5 episode counts differ at T=3")
                elif abs(k_ep - p_ep) > 0.02 * p_ep or abs(k_r - p_r) > 0.01:
                    raise AssertionError("K5 episode statistics disagree")
    return max_err


def zero_counts():
    from drone_tpu_torch.ops import act_rollout_cuda, rollout_cuda

    rollout_cuda.launches = 0
    act_rollout_cuda.launches = 0


def counts() -> dict:
    from drone_tpu_torch.ops import act_rollout_cuda, rollout_cuda

    return {"K1": rollout_cuda.launches, "K5": act_rollout_cuda.launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from drone_tpu_torch import cli
    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops import cuda_acting, cuda_build, cuda_rollout
    from drone_tpu_torch.ops import rollout_cuda
    from drone_tpu_torch.train import evaluate
    from drone_tpu_torch.utils.checkpoint import Checkpointer
    from drone_tpu_torch.utils.config import Config

    t_start = time.time()
    dev = device_line()
    print(dev, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.time()
    libs = cuda_build.build()
    print(f"built {sorted(libs)} in {time.time() - t0:.1f} s", flush=True)
    for name, lib in libs.items():
        log = lib.with_suffix(".so.log").read_text().splitlines()
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in log if "Used " in line})
        spills = [line.strip() for line in log if "spill stores" in line
                  and " 0 bytes spill stores" not in line]
        print(f"  {name}: registers per kernel {regs}; spilling kernels: "
              f"{len(spills)} {spills}", flush=True)

    k1_err = phase_k1()
    k5_err = phase_k5()

    cfg_path = ROOT / "configs" / "hover.toml"
    cfg = Config.from_toml(cfg_path)
    n = cfg.train.num_envs
    statics, params = cfg.env.build()
    env = DroneEnv(statics.task, statics.integrator, params, device="cuda")
    horizon = int(env.params.horizon) + 1

    # -- path 1: the env engine --------------------------------------------
    state = env.init_batch(cfg.run.seed, n)
    zero_counts()
    final, stats = rollout_cuda(state, env.params, env.statics, horizon)
    torch.cuda.synchronize()
    engine_counts = counts()
    print(f"env engine path: {n} lanes x {horizon} steps, episodes "
          f"{float(stats['episodes']):.0f}, reward_sum "
          f"{float(stats['reward_sum']):.6g}, launches {engine_counts}",
          flush=True)
    if engine_counts["K1"] < 1:
        raise AssertionError("the env-engine path did not launch K1")
    if not (torch.isfinite(final.fstate()).all()
            and all(torch.isfinite(v) for v in stats.values())):
        raise AssertionError("env-engine path produced non-finite values")

    # -- path 2: serving (evaluate + cli eval) --------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        Checkpointer(tmp).save(0, seeded_policy(seed=1))
        cfg_eval = cfg.with_overrides([f"run.resume_from={tmp}"])
        zero_counts()
        t0 = time.time()
        res = evaluate(cfg_eval, episodes=n)
        t_eval = time.time() - t0
        rc = cli.main(["eval", str(cfg_path), f"run.resume_from={tmp}"])
        torch.cuda.synchronize()
        serve_counts = counts()
        t0 = time.time()
        evaluate(cfg_eval, episodes=n)
        t_eval_warm = time.time() - t0
        print(f"serving path: evaluate({n} episodes) {res} in {t_eval:.3f} s "
              f"(again: {t_eval_warm:.3f} s); cli eval rc={rc}; launches "
              f"{serve_counts}", flush=True)
        if serve_counts["K5"] < 2 or rc != 0:
            raise AssertionError("the serving path did not launch K5 twice")
        if not all(v == v and abs(v) != float("inf") for v in res.values()):
            raise AssertionError("evaluate returned non-finite stats")
        if res["episodes"] < n or not 1.0 <= res["ep_length_mean"] <= horizon:
            raise AssertionError(f"implausible evaluate stats {res}")

        # -- the card against the CPU on a small input ------------------------
        small_gpu = evaluate(cfg_eval, episodes=512, device="cuda")
        small_cpu = evaluate(cfg_eval, episodes=512, device="cpu")
        print(f"evaluate(512) card {small_gpu} cpu {small_cpu}", flush=True)
        if (abs(small_gpu["episodes"] - small_cpu["episodes"])
                > 0.01 * small_cpu["episodes"]
                or abs(small_gpu["ep_return_mean"] - small_cpu["ep_return_mean"])
                > 0.01 * abs(small_cpu["ep_return_mean"])):
            raise AssertionError("evaluate on the card disagrees with the CPU")

    # -- times at the paths' shapes --------------------------------------------
    lane_steps = n * horizon
    k1_ms = cuda_ms(lambda: cuda_rollout.rollout_kernel(
        state, env.params, env.statics, horizon), reps=10)
    t0 = time.time()
    cuda_rollout.rollout_plain(state, env.params, env.statics, horizon)
    torch.cuda.synchronize()
    k1_plain_ms = (time.time() - t0) * 1e3
    k1_ops = (lane_steps * (OPS_STEP + OPS_RANDOM_ACTIONS)
              + float(stats["episodes"]) * OPS_RESET)
    k1_bytes = n * (2 * 25 * 4 + 5 * 4)  # state in and out, stats out

    policy = seeded_policy(seed=1).cuda()
    state = env.init_batch(cfg.run.seed + 1, n)
    _, k5_lane = cuda_acting.act_rollout_kernel(state, policy, env.params,
                                                env.statics, horizon)
    k5_episodes = float(k5_lane[1].sum())
    k5_ms = cuda_ms(lambda: cuda_acting.act_rollout_kernel(
        state, policy, env.params, env.statics, horizon), reps=5)
    t0 = time.time()
    cuda_acting.act_rollout_plain(state, policy, env.params, env.statics,
                                  horizon)
    torch.cuda.synchronize()
    k5_plain_ms = (time.time() - t0) * 1e3
    k5_ops = (lane_steps * (OPS_STEP + OPS_OBS + tower_ops((64, 64)))
              + k5_episodes * OPS_RESET)
    k5_bytes = n * (2 * 25 * 4 + 5 * 4) + 4 * (13 * 64 + 64 * 64 + 64 * 4
                                             + 64 + 64 + 4)

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    k1_bound, k1_by = bound(k1_ops, k1_bytes)
    k5_bound, k5_by = bound(k5_ops, k5_bytes)
    print(f"K1 {n} x {horizon}: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.1f} "
          f"ms, bound {k1_bound:.4f} ms ({k1_ops:.4g} ops)", flush=True)
    print(f"K5 {n} x {horizon}: kernel {k5_ms:.4f} ms, plain {k5_plain_ms:.1f} "
          f"ms, bound {k5_bound:.4f} ms ({k5_ops:.4g} ops)", flush=True)
    print(f"total {time.time() - t_start:.1f} s", flush=True)

    kernels = [
        {"name": "K1 env rollout", "route": "cuda",
         "source": "drone_tpu_torch/csrc/rollout.cu",
         "replaces": "drone_tpu/ops/pallas_rollout.py:460",
         "launches": engine_counts["K1"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "K5 MLP acting", "route": "cuda",
         "source": "drone_tpu_torch/csrc/acting.cu",
         "replaces": "drone_tpu/ops/pallas_acting.py:109",
         "launches": serve_counts["K5"], "max_abs_err": k5_err,
         "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k5_bound,
         "bound_by": k5_by, "library_ms": None},
    ]
    print(dev, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
