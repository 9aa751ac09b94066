"""CLI: `python -m drone_tpu_torch.cli
{train,eval,bench,sweep,export,autotune,watch} [config.toml]
[section.key=value ...] [--device cuda|cpu] [--out PATH]`.

Counterpart of `drone_tpu/cli.py`, with the same subcommands and argument
handling. Every subcommand that runs the env or a policy takes --device
(cuda by default; cpu runs the kernels' plain versions). `export` reads
the latest checkpoint and launches nothing, so it takes no --device.
`train` under torchrun (WORLD_SIZE > 1 in the environment) joins the
process group torchrun describes, and `build` shards the run over it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from drone_tpu_torch.utils.config import Config


def _load_config(args) -> Config:
    config_path = args.config
    overrides = list(args.overrides)
    # `config` is optional; a first positional with '=' is an override
    if config_path and "=" in config_path:
        overrides.insert(0, config_path)
        config_path = None
    cfg = Config.from_toml(config_path) if config_path else Config.default()
    return cfg.with_overrides(overrides)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="drone_tpu_torch",
        description="quadrotor RL environment + policies on PyTorch/CUDA",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    for name, helptext in (
        ("train", "run PPO training"),
        ("eval", "evaluate a checkpoint"),
        ("bench", "measure env throughput"),
        ("sweep", "hyperparameter sweep ([sweep] section)"),
        ("export", "export actor weights for the C runtime (DRNW)"),
        ("autotune", "measure train-SPS over batch shapes, report the best"),
        ("watch", "roll out the latest checkpoint and render a PNG/GIF"),
    ):
        p = sub.add_parser(name, help=helptext)
        p.add_argument("config", nargs="?", default=None,
                       help="TOML config file (optional)")
        p.add_argument("overrides", nargs="*",
                       help="dotted overrides, e.g. run.seed=3 env.task=waypoint")
        if name != "export":
            p.add_argument("--device", default="cuda",
                           help="cuda (default) or cpu for the plain versions")
        if name == "export":
            p.add_argument("--out", default="policy.drnw")
        if name == "autotune":
            p.add_argument("--iters", type=int, default=3,
                           help="timed updates per candidate (after warmup)")
        if name == "watch":
            p.add_argument("--out", default="flight.gif",
                           help=".gif (animated) or .png (static)")
            p.add_argument("--steps", type=int, default=0,
                           help="rollout length (default: env horizon)")
        if name == "sweep":
            p.add_argument("--out", default=None,
                           help="results JSON path (default: "
                                "<checkpoint_dir>/<run_name>-sweep.json)")
            p.add_argument("--resume", action="store_true",
                           help="replay the sweep journal and continue an "
                                "interrupted sweep")
    args = parser.parse_args(argv)
    cfg = _load_config(args)
    if args.cmd == "bench":
        from drone_tpu_torch import bench

        bench.main(cfg, device=args.device)
        return 0
    if args.cmd == "export":
        _export(cfg, args.out)
        return 0
    if args.cmd == "train":
        from drone_tpu_torch.train import train

        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            from drone_tpu_torch.parallel.multihost import initialize_multihost

            initialize_multihost(device=args.device)
        train(cfg, device=args.device)
        return 0
    if args.cmd == "sweep":
        return _sweep(cfg, args.out, args.resume, args.device)
    if args.cmd == "autotune":
        return _autotune(cfg, args.iters, args.device)
    if args.cmd == "watch":
        return _watch(cfg, args.out, args.steps, args.device)
    from drone_tpu_torch.train import evaluate

    stats = evaluate(cfg, device=args.device)
    print(json.dumps(stats, indent=2))
    return 0


def _sweep(cfg: Config, out, resume: bool, device) -> int:
    from pathlib import Path

    from drone_tpu_torch.sweep import run_sweep

    out = out or str(Path(cfg.run.checkpoint_dir)
                     / f"{cfg.run.run_name}-sweep.json")
    results = run_sweep(cfg, out_path=out, resume=resume, device=device)
    print("best:", json.dumps(results[0]))
    print(f"results: {out} (journal: {out}.jsonl)")
    return 0


def _autotune(cfg: Config, iters: int, device) -> int:
    from drone_tpu_torch.autotune import autotune

    results = autotune(cfg, iters=iters, device=device)
    if not results:
        print("autotune: no candidate shape succeeded", file=sys.stderr)
        return 1
    best = results[0]
    print(json.dumps(results))
    print(f"best: {best['sps'] / 1e6:.2f}M SPS ({best['trainer']}) -> "
          f"{best['overrides']}")
    return 0


def _watch(cfg: Config, out: str, steps: int, device) -> int:
    """Render an episode of the latest checkpoint (the reference's
    checkpoint -> policy rollout -> CSV -> PNG/GIF): the CSV beside `out`,
    then the render (viz.viewer, which needs matplotlib)."""
    from pathlib import Path

    from drone_tpu_torch.viewer import watch_rollout
    from viz.viewer import load_csv, render, render_gif

    csv_path = str(Path(out).with_suffix(".csv"))
    gates = watch_rollout(cfg, csv_path, steps, device)
    rows = load_csv(csv_path)
    out = (render_gif(rows, out, gates=gates) if out.endswith(".gif")
           else render(rows, out, gates=gates))
    print(f"wrote {out} (trajectory: {csv_path})")
    return 0


def _export(cfg: Config, out: str) -> None:
    """The latest checkpoint's actor as DRNW at `out`, and the env params
    for the C demo at `out`.params."""
    from drone_tpu_torch.models.export import export_flat_weights, export_params
    from drone_tpu_torch.train import build_env_and_model, restore_dir
    from drone_tpu_torch.utils.checkpoint import Checkpointer

    raw, _ = Checkpointer(restore_dir(cfg)).restore_raw()
    # the model carries the authoritative conv geometry (strides are not
    # recorded in params — see export_flat_weights)
    _, model = build_env_and_model(cfg, device="cpu")
    export_flat_weights(raw["params"], out, hidden=tuple(cfg.run.hidden),
                        model=model)
    _, env_params = cfg.env.build()
    export_params(env_params, out + ".params")
    print(f"wrote {out} and {out}.params")


if __name__ == "__main__":
    sys.exit(main())
