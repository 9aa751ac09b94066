"""Multi-process distributed smoke worker (one simulated host).

    python -m drone_tpu_torch.parallel._smoke_worker <port> <nproc> <pid>
        [trainer] [device] [backend] [--config TOML] [--dump DIR]
        [section.key=value ...]

trainer: "scan" (default) or "pallas" (the MLP megakernel trainer: its
kernels on a CUDA device, their plain versions on the CPU); device: "cuda"
(default) or "cpu"; backend: the process group's, "nccl" with CUDA and
"gloo" otherwise unless named (two ranks sharing one card take "gloo":
NCCL refuses two ranks on one device). Counterpart of
`drone_tpu/parallel/_smoke_worker.py`: every process joins the group at
localhost:<port>, builds the run through `train.build` (which shards it
over the group) and runs run.total_updates updates of its lanes, then
prints

    SMOKE_OK pid=<pid> world=<nproc> kind=<trainer kind> loss=<loss>
        kl=<approx_kl> launches=<K2>,<K3>,<K4>

(on one line; the launch counts of the MLP megakernel's kernels, 0 on the
CPU). The run is --config (a small default: hidden (16, 16), horizon 8,
one epoch of two minibatches, two updates, 8 lanes a rank for the scan
trainer and 256 for the megakernel, 16,384 on a card) with the overrides
after it; train.num_envs is the GLOBAL lane count. --dump DIR saves the
rank's parameters, optimizer state, metrics and env state to
DIR/rank<pid>.pt.

The loss must agree bitwise across processes: the parameters stay
replicated through the averaged gradients.
"""

import argparse
from pathlib import Path


def parse(argv=None):
    p = argparse.ArgumentParser(prog="_smoke_worker")
    p.add_argument("port")
    p.add_argument("nproc", type=int)
    p.add_argument("pid", type=int)
    p.add_argument("trainer", nargs="?", default="scan",
                   choices=("scan", "pallas"))
    p.add_argument("device", nargs="?", default="cuda")
    p.add_argument("backend", nargs="?", default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--dump", default=None)
    return p.parse_known_args(argv)


def main(argv=None):
    args, overrides = parse(argv)

    import torch
    import torch.distributed as dist

    from drone_tpu_torch import train
    from drone_tpu_torch.ops import fused_adam_cuda, ppo_update_cuda
    from drone_tpu_torch.ops import traj_rollout_cuda
    from drone_tpu_torch.parallel.multihost import initialize_multihost
    from drone_tpu_torch.utils.config import Config

    mesh = initialize_multihost(f"localhost:{args.port}", args.nproc,
                                args.pid, args.backend, device=args.device)
    if args.config is None:
        # megakernel lanes a rank: rows of 128 for each of 2 minibatches, at
        # a width that loads the card there
        lanes = (8 if args.trainer == "scan" else
                 16384 if mesh.device.type == "cuda" else 256)
        cfg = Config.default().with_overrides([
            "run.hidden=16,16", "train.horizon=8", "train.epochs=1",
            "train.num_minibatches=2", "run.total_updates=2",
            f"train.num_envs={lanes * mesh.world}"])
    else:
        cfg = Config.from_toml(args.config)
    cfg = cfg.with_overrides(
        ["run.mesh=true",
         f"run.rollout={'scan' if args.trainer == 'scan' else 'pallas'}"]
        + overrides)
    env, model, runner, step, cfg = train.build(cfg, mesh.device)
    kernels = (traj_rollout_cuda, ppo_update_cuda, fused_adam_cuda)
    for k in kernels:
        k.launches = 0
    for _ in range(cfg.run.total_updates):
        runner, m = step(runner)
    loss = float(m["loss"])
    kl = float(m["approx_kl"])
    launches = ",".join(str(k.launches) for k in kernels)
    if args.dump is not None:
        torch.save({"params": runner.params.flat, "opt_state": runner.opt_state,
                    "metrics": m, "env_state": runner.env_state.fstate()},
                   Path(args.dump) / f"rank{args.pid}.pt")
    print(f"SMOKE_OK pid={args.pid} world={mesh.world} kind={step.kind} "
          f"loss={loss!r} kl={kl!r} launches={launches}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
