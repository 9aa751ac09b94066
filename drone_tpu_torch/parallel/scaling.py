"""Scaling harness: sharded train-step throughput against the world size
(counterpart of `drone_tpu/parallel/scaling.py`).

Runs the same sharded PPO train step (the scan trainer, as the reference)
over worlds of 1, 2, 4, ... ranks with the env batch scaled with them (weak
scaling: more devices, more drones), and reports steps/s and the
efficiency against the per-rank throughput of the FIRST entry of
device_counts. Each world is that many processes started with spawn, one
rank a device: NCCL with one card a rank on CUDA, Gloo on the CPU (where
the ranks share the host's cores, so the efficiency says nothing of a
device). Each timed region ends with a value read.
"""

from __future__ import annotations

import copy
import dataclasses
import socket
import time

import torch

from drone_tpu_torch import ppo as ppo_mod


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, device_type, task, integrator, params,
               model, cfg, iters, queue):
    """One rank of a world: build its shard, warm up, time `iters`
    updates; rank 0 puts the steps/s on the queue."""
    import torch.distributed as dist

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.parallel import make_sharded_train_step
    from drone_tpu_torch.parallel.multihost import (
        global_init_runner,
        initialize_multihost,
    )

    mesh = initialize_multihost(f"localhost:{port}", world, rank,
                                device=device_type)
    env = DroneEnv(task, integrator, params.to(mesh.device),
                   device=mesh.device)

    def init_fn(first_lane, num_envs):
        return ppo_mod.init_runner(
            model, env, dataclasses.replace(cfg, num_envs=num_envs), seed=0,
            first_lane=first_lane)

    runner = global_init_runner(init_fn, mesh, cfg.num_envs)
    step = make_sharded_train_step(runner.params, env, cfg, mesh)
    runner, m = step(runner)
    float(m["loss"])  # warm-up, then a hard sync
    t0 = time.perf_counter()
    for _ in range(iters):
        runner, m = step(runner)
    float(m["loss"])
    dt = time.perf_counter() - t0
    if rank == 0:
        queue.put(cfg.num_envs * cfg.horizon * iters / dt)
    dist.destroy_process_group()


def run_scaling(env, model, cfg: ppo_mod.PPOConfig,
                envs_per_device: int = 4096, iters: int = 3,
                device_counts=None) -> list[dict]:
    """Weak-scaling sweep on env's device type. Returns one record per
    world size: {devices, num_envs, steps_per_s, efficiency}. By default
    the worlds are the powers of two up to the CUDA device count (1 on the
    CPU)."""
    cuda = env.device.type == "cuda"
    if device_counts is None:
        n_avail = torch.cuda.device_count() if cuda else 1
        device_counts = []
        n = 1
        while n <= n_avail:
            device_counts.append(n)
            n *= 2
    # the ranks rebuild the env and the model on their own device from CPU
    # tensors
    params = env.params.to("cpu")
    model = copy.deepcopy(model).to("cpu")
    ctx = torch.multiprocessing.get_context("spawn")
    records = []
    base = None
    for n_dev in device_counts:
        c = dataclasses.replace(cfg, num_envs=envs_per_device * n_dev)
        queue = ctx.SimpleQueue()
        torch.multiprocessing.start_processes(
            _rank_main, args=(n_dev, _free_port(), env.device.type,
                              env.statics.task, env.statics.integrator,
                              params, model, c, iters, queue),
            nprocs=n_dev, start_method="spawn")
        sps = queue.get()
        if base is None:
            base = sps / n_dev  # per-rank throughput of the first world
        records.append({
            "devices": n_dev,
            "num_envs": c.num_envs,
            "steps_per_s": round(sps, 1),
            "efficiency": round(sps / (base * n_dev), 3),
        })
    return records


def main(argv=None):
    import argparse
    import json

    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.models import ActorCritic

    ap = argparse.ArgumentParser(description="weak-scaling sweep")
    ap.add_argument("--envs-per-device", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: NCCL, one card a rank) or cpu "
                         "(Gloo)")
    args = ap.parse_args(argv)
    env = DroneEnv(device=args.device)
    cfg = ppo_mod.PPOConfig(horizon=args.horizon, epochs=2, num_minibatches=2)
    model = ActorCritic(generator=torch.Generator().manual_seed(0))
    for rec in run_scaling(env, model, cfg,
                           envs_per_device=args.envs_per_device):
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
