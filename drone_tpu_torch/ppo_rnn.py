"""Recurrent PPO pieces (counterpart of `drone_tpu/ppo_rnn.py`).

The runner state of the recurrent trainer (the MLP runner plus the LSTM
carry), its initialisation, the per-lane carry reset on episode end, and
the module rollout that evaluation takes for a stochastic or ragged run.
The recurrent megakernel trainer is `ppo_rnn_cuda.make_rnn_train_step`;
`segmented_forward` and the scan trainer are still to port (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.ppo import PPOConfig, RunnerState, init_fused_opt_state
from drone_tpu_torch.rollout import _stack_outs


@dataclasses.dataclass
class RecurrentRunnerState(RunnerState):
    """RunnerState plus the LSTM carry (c, h), each (N, hidden), entering
    the next update's first step."""

    carry: tuple = ()


def mask_carry(carry, done):
    """Zero the recurrent state of lanes whose episode just ended
    (ppo_rnn._mask_carry)."""
    keep = (1.0 - done.to(torch.float32))[:, None]
    return tuple(t * keep for t in carry)


def init_recurrent_runner(model, env, cfg: PPOConfig,
                          seed: int = 0) -> RecurrentRunnerState:
    """Fresh RecurrentRunnerState: the LSTMActorCritic (or
    CNNLSTMActorCritic) moved to the env's device and flattened, a zero fused optimizer state, cfg.num_envs lanes
    of episode 0 under `seed`, a zero carry, and the permutation generator
    seeded with `seed`."""
    model = model.to(env.device)
    flat = model.flatten_()
    env_state = env.init_batch(seed, cfg.num_envs)
    return RecurrentRunnerState(
        params=model,
        opt_state=init_fused_opt_state(flat),
        env_state=env_state,
        last_obs=env_mod.observe(env_state),
        generator=torch.Generator().manual_seed(seed),
        update_idx=0,
        carry=model.initial_carry(cfg.num_envs, env.device),
    )


@torch.no_grad()
def rollout_recurrent(model, env, state, carry, steps: int,
                      generator: torch.Generator | None = None,
                      deterministic: bool = True):
    """Policy rollout for evaluation through the module (either recurrent
    family): returns (final_state, final_carry, StepOut stacked over T). A
    stochastic rollout draws its noise from `generator` (on the env's
    device)."""
    if generator is None and not deterministic:
        raise ValueError("a stochastic rollout_recurrent needs a generator")
    obs = env_mod.observe(state)
    outs = []
    for _ in range(steps):
        mean, log_std, _, carry = model(obs, carry)
        action = mean
        if not deterministic:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device)
            action = mean + torch.exp(log_std) * noise
        state, out = env_mod.step(state, action, env.params, env.statics)
        carry = mask_carry(carry, out.terminated | out.truncated)
        obs = out.obs
        outs.append(out)
    return state, carry, _stack_outs(outs)
