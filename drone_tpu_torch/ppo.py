"""PPO hyperparameters (counterpart of `drone_tpu/ppo.py:PPOConfig`).

Only the config the `[train]` section of a TOML file needs; the trainer is
still to port (ROADMAP.md)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Static training hyperparameters, with the reference's defaults."""

    horizon: int = 128          # rollout length T per update
    num_envs: int = 4096        # lanes B
    epochs: int = 4
    num_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_clip: float = 10.0
    vf_coef: float = 0.5
    ent_coef: float = 0.001
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    anneal_lr: bool = False
    total_updates: int = 200    # used by lr annealing
    shuffle: str = "lanes"      # "lanes" | "flat" minibatch shuffling
    bptt_horizon: int = 0       # recurrent PPO: truncated-BPTT segment length
    grad_accum: int = 1         # scan trainer: gradient-accumulation chunks
