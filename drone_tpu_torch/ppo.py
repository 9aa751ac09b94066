"""PPO pieces shared by the trainers (counterpart of `drone_tpu/ppo.py`).

PPOConfig, the Gaussian policy's log-prob and entropy, GAE, and the
runner state a train step carries. The megakernel trainer is
`ppo_cuda.make_train_step`; the scan trainer (autograd and an optax-shaped
optimizer state) is still to port (ROADMAP.md).

Conventions (the reference's CleanRL lineage): done = terminated |
truncated ends bootstrapping; advantages are normalized over the batch; a
Gaussian policy with a state-independent log_std and a raw (unsquashed)
log-prob.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.types import EnvState


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


_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_logp(action, mean, log_std):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return torch.sum(-0.5 * z * z - log_std - 0.5 * _LOG_2PI, dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * (1.0 + _LOG_2PI), dim=-1)


def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """Generalized advantage estimation by a reverse loop over time.

    rewards/values/dones: (T, ...); last_value: (...). Returns (advantages,
    returns), each shaped like rewards."""
    nonterminal = 1.0 - dones.to(torch.float32)
    adv = torch.empty_like(rewards)
    next_adv = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * nonterminal[t] - values[t]
        next_adv = delta + gamma * lam * nonterminal[t] * next_adv
        adv[t] = next_adv
        next_value = values[t]
    return adv, adv + values


@dataclasses.dataclass
class RunnerState:
    """What a train step carries from one update to the next.

    params: an ActorCritic whose parameters are views of one flat buffer
    (`params.flat`, `ActorCritic.flatten_`); opt_state: (count 0-d float32,
    mu, nu), flat buffers in the same order; generator: the CPU generator of
    the minibatch permutations."""

    params: torch.nn.Module
    opt_state: tuple
    env_state: EnvState
    last_obs: torch.Tensor
    generator: torch.Generator
    update_idx: int = 0


def init_fused_opt_state(flat: torch.Tensor):
    """Fresh (count, mu, nu) of the fused optimizer for a flat parameter
    buffer: a zero step count and zero moments."""
    return (torch.zeros((), dtype=torch.float32, device=flat.device),
            torch.zeros_like(flat), torch.zeros_like(flat))


def init_runner(model, env, cfg: PPOConfig, seed: int = 0) -> RunnerState:
    """Fresh RunnerState: the model moved to the env's device and
    flattened, a zero optimizer state, cfg.num_envs lanes of episode 0
    under `seed`, and the permutation generator seeded with `seed`."""
    model = model.to(env.device)
    flat = model.flatten_()
    env_state = env.init_batch(seed, cfg.num_envs)
    return RunnerState(
        params=model,
        opt_state=init_fused_opt_state(flat),
        env_state=env_state,
        last_obs=env_mod.observe(env_state),
        generator=torch.Generator().manual_seed(seed),
        update_idx=0,
    )
