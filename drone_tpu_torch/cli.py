"""CLI: `python -m drone_tpu_torch.cli {train,eval,bench} [config.toml]
[section.key=value ...] [--device cuda|cpu]`.

Counterpart of `drone_tpu/cli.py`, with the same subcommands and argument
handling. `train`, `eval` and `bench` are ported; the others exit with
status 2 and name the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import json
import sys

from drone_tpu_torch.utils.config import Config

_UNPORTED = {
    "sweep": "outer surfaces",
    "export": "outer surfaces",
    "autotune": "outer surfaces",
    "watch": "outer surfaces",
}


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
        if name in ("train", "eval", "bench"):
            p.add_argument("--device", default="cuda",
                           help="cuda (default) or cpu for the plain versions")
    args = parser.parse_args(argv)

    if args.cmd in _UNPORTED:
        print(f"drone_tpu_torch: '{args.cmd}' is not ported yet "
              f"(ROADMAP.md, module queue: {_UNPORTED[args.cmd]})",
              file=sys.stderr)
        return 2
    cfg = _load_config(args)
    if args.cmd == "bench":
        from drone_tpu_torch import bench

        bench.main(cfg, device=args.device)
        return 0
    if args.cmd == "train":
        from drone_tpu_torch.train import train

        train(cfg, device=args.device)
        return 0
    from drone_tpu_torch.train import evaluate

    stats = evaluate(cfg, device=args.device)
    print(json.dumps(stats, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
