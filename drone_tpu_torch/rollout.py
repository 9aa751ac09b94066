"""Batched Python-loop rollouts (counterpart of `drone_tpu/rollout.py`,
where lax.scan becomes a loop and vmap a leading lane axis)."""

from __future__ import annotations

import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.types import EnvParams, EnvState, EnvStatics, StepOut


def _stack_outs(outs: list[StepOut]) -> StepOut:
    return StepOut(**{name: torch.stack([getattr(o, name) for o in outs])
                      for name in StepOut.__dataclass_fields__})


def rollout_actions(state: EnvState, actions, p: EnvParams,
                    statics: EnvStatics):
    """Step every lane through a precomputed (T, N, 4) action sequence.
    Returns (final_state, StepOut stacked over T)."""
    outs = []
    for a in actions:
        state, out = env_mod.step(state, a, p, statics)
        outs.append(out)
    return state, _stack_outs(outs)


def rollout_actions_packed(state: EnvState, actions, p: EnvParams,
                           statics: EnvStatics):
    """Like rollout_actions, also recording the (N, 19) oracle fstate after
    every step, stacked to (T, N, 19), for bitwise comparison."""
    outs, packed = [], []
    for a in actions:
        state, out = env_mod.step(state, a, p, statics)
        outs.append(out)
        packed.append(state.fstate())
    return state, (_stack_outs(outs), torch.stack(packed))


def rollout_policy(state: EnvState, policy_fn, steps: int, p: EnvParams,
                   statics: EnvStatics, generator: torch.Generator | None = None):
    """Batched policy rollout: policy_fn(obs (N, 13), generator) ->
    (actions (N, 4), aux). Returns (final_state, (StepOut stacked over T,
    list of aux))."""
    obs = env_mod.observe(state)
    outs, auxs = [], []
    for _ in range(steps):
        actions, aux = policy_fn(obs, generator)
        state, out = env_mod.step(state, actions, p, statics)
        obs = out.obs
        outs.append(out)
        auxs.append(aux)
    return state, (_stack_outs(outs), auxs)
