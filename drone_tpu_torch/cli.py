"""CLI: `python -m drone_tpu_torch.cli {train,eval,bench,export}
[config.toml] [section.key=value ...] [--device cuda|cpu] [--out PATH]`.

Counterpart of `drone_tpu/cli.py`, with the same subcommands and argument
handling. `train`, `eval`, `bench` and `export` are ported; the others exit
with status 2 and name the ROADMAP.md item that ports them. `export` reads
the latest checkpoint and launches nothing, so it takes no --device.
"""

from __future__ import annotations

import argparse
import json
import sys

from drone_tpu_torch.utils.config import Config

_UNPORTED = {
    "sweep": "outer surfaces",
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
        if name == "export":
            p.add_argument("--out", default="policy.drnw")
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
    if args.cmd == "export":
        _export(cfg, args.out)
        return 0
    if args.cmd == "train":
        from drone_tpu_torch.train import train

        train(cfg, device=args.device)
        return 0
    from drone_tpu_torch.train import evaluate

    stats = evaluate(cfg, device=args.device)
    print(json.dumps(stats, indent=2))
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
