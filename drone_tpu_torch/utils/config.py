"""Typed config: dataclasses + TOML files + dotted CLI overrides.

Counterpart of `drone_tpu/utils/config.py`, with the same sections
([run], [env], [train], [sweep]) and override syntax, so the repo's
`configs/*.toml` load unchanged.
"""

from __future__ import annotations

import dataclasses
import tomllib
from pathlib import Path
from typing import Any

import numpy as np

from drone_tpu_torch import ppo as ppo_mod
from drone_tpu_torch.types import EnvParams, EnvStatics, default_params


@dataclasses.dataclass
class RunConfig:
    """[run] section: experiment-level settings (the reference's fields;
    the port reads those of the paths it has ported)."""

    seed: int = 0
    total_updates: int = 500
    log_interval: int = 10
    checkpoint_interval: int = 100
    checkpoint_dir: str = "experiments"
    run_name: str = "run"
    metrics_path: str = ""          # default: <checkpoint_dir>/<run>/metrics.jsonl
    resume_from: str = ""           # checkpoint dir to resume / evaluate from
    mesh: bool = True               # shard over all local devices
    hidden: tuple = (64, 64)
    policy: str = "mlp"             # "mlp" | "lstm" | "cnn" | ...
    lstm_hidden: int = 128
    tensorboard: bool = False
    dashboard: str = "plain"        # "plain" | "rich"
    save_final: bool = True
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    rollout: str = "auto"           # "scan" | "pallas" | "auto"
    profile_dir: str = ""


@dataclasses.dataclass
class EnvConfig:
    """[env] section: task + any EnvParams field as override."""

    task: str = "hover"
    integrator: str = "euler"
    params: dict = dataclasses.field(default_factory=dict)

    def build(self) -> tuple[EnvStatics, EnvParams]:
        """(statics, params on the CPU); DroneEnv moves params to its device."""
        statics = EnvStatics(task=self.task, integrator=self.integrator)
        overrides = {}
        for k, v in self.params.items():
            if k in ("horizon", "n_gates"):
                overrides[k] = np.int32(v)
            elif k in ("target", "gates"):
                overrides[k] = np.asarray(v, np.float32)
            else:
                overrides[k] = np.float32(v)
        return statics, default_params(self.task, **overrides)


def _coerce(current: Any, raw: str) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        return tuple(int(x) for x in raw.strip("()").split(",") if x)
    return raw


@dataclasses.dataclass
class Config:
    run: RunConfig
    env: EnvConfig
    train: ppo_mod.PPOConfig
    sweep: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def default(cls) -> "Config":
        return cls(run=RunConfig(), env=EnvConfig(), train=ppo_mod.PPOConfig())

    @classmethod
    def from_toml(cls, path: str | Path) -> "Config":
        with open(path, "rb") as f:
            data = tomllib.load(f)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "Config":
        run = RunConfig(**{k: (tuple(v) if k == "hidden" else v)
                           for k, v in data.get("run", {}).items()})
        envd = dict(data.get("env", {}))
        env = EnvConfig(
            task=envd.pop("task", "hover"),
            integrator=envd.pop("integrator", "euler"),
            params=envd,  # remaining [env] keys are EnvParams overrides
        )
        train = ppo_mod.PPOConfig(**data.get("train", {}))
        return cls(run=run, env=env, train=train, sweep=data.get("sweep", {}))

    def copy(self) -> "Config":
        """Independent copy: no dataclass or dict leaves shared with self."""
        return Config(
            run=dataclasses.replace(self.run),
            env=dataclasses.replace(self.env, params=dict(self.env.params)),
            train=dataclasses.replace(self.train),
            sweep=dict(self.sweep),
        )

    def with_overrides(self, overrides: list[str]) -> "Config":
        """Apply dotted overrides: ['train.lr=1e-4', 'env.task=waypoint',
        'env.params.mass=0.5', 'run.seed=3']. Returns a new Config."""
        cfg = self.copy()
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"override must be section.key=value: {item!r}")
            key, _, raw = item.partition("=")
            parts = key.split(".")
            if parts[0] == "train":
                cur = getattr(cfg.train, parts[1])
                cfg = dataclasses.replace(
                    cfg, train=dataclasses.replace(
                        cfg.train, **{parts[1]: _coerce(cur, raw)}))
            elif parts[0] == "run":
                cur = getattr(cfg.run, parts[1])
                setattr(cfg.run, parts[1], _coerce(cur, raw))
            elif parts[0] == "env":
                if parts[1] == "params":
                    cfg.env.params[parts[2]] = float(raw)
                else:
                    cur = getattr(cfg.env, parts[1])
                    setattr(cfg.env, parts[1], _coerce(cur, raw))
            else:
                raise ValueError(f"unknown config section {parts[0]!r}")
        return cfg
