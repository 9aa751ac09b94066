"""Gymnasium interoperability layer.

Counterpart of `drone_tpu/emulation.py`: the drone env as a standard
`gymnasium.Env` (and `gymnasium.vector.VectorEnv`), so it drops into any
Gymnasium-based stack (SB3, CleanRL, ...).

Gymnasium semantics differ from the internal (PufferEnv-style) convention
in one place: on termination Gymnasium returns the TERMINAL observation and
the user must call reset(), while the internal step auto-resets and returns
the new episode's first obs. The adapters use `env.step_terminal` to honor
the Gymnasium contract exactly; the post-termination state is the auto-reset
state, so `reset()` after a done step is free (and reproducible: episode
RNG streams are counter-based).

gymnasium is optional: without it the adapters are structurally identical
duck-typed classes (same methods, `spaces.Box` spaces). Each adapter runs
on `device`, the card unless the caller asks for the CPU, and reads each
step's results back in one device-to-host copy (`vector.fetch`).
"""

from __future__ import annotations

import numpy as np
import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch import prng, spaces
from drone_tpu_torch.types import ACT_DIM, EnvParams
from drone_tpu_torch.vector import fetch

try:  # pragma: no cover
    import gymnasium as _gym

    _EnvBase = _gym.Env
except ImportError:  # pragma: no cover
    _gym = None
    _EnvBase = object


class DroneGymnasium(_EnvBase):
    """Single-drone `gymnasium.Env` over the batched step (a batch of one
    lane).

    >>> env = DroneGymnasium(task="hover")
    >>> obs, info = env.reset(seed=0)
    >>> obs, r, term, trunc, info = env.step(env.action_space.sample())
    """

    metadata = {"render_modes": []}

    def __init__(self, task: str = "hover", integrator: str = "euler",
                 params: EnvParams | None = None, device="cuda"):
        self.env = env_mod.DroneEnv(task=task, integrator=integrator,
                                    params=params, device=device)
        self.observation_space = spaces.observation_space()
        self.action_space = spaces.action_space()
        self._state = None
        self._needs_reset = True
        self._stepped = False  # host-side: any step since last (auto-)reset?
        self._seed = 0
        self._lane = 0

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if seed is not None:
            self._seed = seed
            self._state = self.env.init(seed, self._lane)
        elif self._state is None:
            self._state = self.env.init(self._seed, self._lane)
        elif not self._needs_reset and self._stepped:
            # mid-episode reset (e.g. an external TimeLimit wrapper): abandon
            # the running episode and start the next one in the lane's
            # counter-based stream, the episode the auto-reset would give
            # (a host-side flag, so no device-to-host read of state.step)
            s = self._state
            self._state = env_mod.reset_state(
                s.key0, s.key1, prng.to_u32(s.reset_count) + 1,
                self.env.params, self.env.statics)
        # else: the internal step already auto-reset; the current state IS
        # the fresh episode (counter-based RNG: the same stream either way)
        self._needs_reset = False
        self._stepped = False
        obs = self.env.observe(self._state)[0].cpu().numpy()
        return obs, {}

    def step(self, action):
        if self._needs_reset:
            raise RuntimeError("episode is done — call reset() first")
        action = torch.as_tensor(
            np.asarray(action, np.float32).reshape(1, ACT_DIM),
            device=self.env.device)
        state, out, terminal_obs = env_mod.step_terminal(
            self._state, action, self.env.params, self.env.statics)
        self._state = state
        self._stepped = True
        host = fetch(out, terminal_obs)
        terminated = bool(host.terminated[0])
        truncated = bool(host.truncated[0])
        info = {}
        if terminated or truncated:
            self._needs_reset = True
            obs = host.terminal_obs[0].copy()
            info["episode"] = {
                "r": float(host.ep_return[0]),
                "l": int(host.ep_length[0]),
            }
        else:
            obs = host.obs[0].copy()
        return obs, float(host.reward[0]), terminated, truncated, info

    def render(self):  # trajectory rendering lives in viz/; nothing live here
        return None

    def close(self):
        self._state = None


def make_gymnasium(task: str = "hover", **kwargs) -> DroneGymnasium:
    return DroneGymnasium(task=task, **kwargs)


# ---------------------------------------------------------------------------
# Vectorized gymnasium adapter (SB3-style consumers).
# ---------------------------------------------------------------------------

try:  # pragma: no cover
    from gymnasium.vector import VectorEnv as _VectorEnvBase
    from gymnasium.vector.utils import batch_space as _batch_space
except ImportError:  # pragma: no cover
    _VectorEnvBase = object
    _batch_space = None


def _batched(space, n: int):
    """`space` stacked n times: gymnasium's batch_space, or a `spaces.Box`
    without gymnasium."""
    if _batch_space is not None:
        return _batch_space(space, n)
    shape = (n,) + tuple(space.shape)
    return spaces.Box(low=np.broadcast_to(space.low, shape).copy(),
                      high=np.broadcast_to(space.high, shape).copy(),
                      shape=shape)


class DroneVectorGymnasium(_VectorEnvBase):
    """`gymnasium.vector.VectorEnv` over the batched step.

    SAME_STEP autoreset semantics (the env's native convention): on a done
    step the returned observation is the NEW episode's first obs, and the
    terminal observation is delivered through infos as both "final_obs"
    (gymnasium >= 1.0 naming) and "final_observation" (SB3/0.29 naming),
    masked by infos["_final_obs"]. The whole batch is one batched
    step_terminal, no worker processes.
    """

    metadata = {"autoreset_mode": "SameStep"}

    def __init__(self, num_envs: int, task: str = "hover",
                 integrator: str = "euler", params: EnvParams | None = None,
                 seed: int = 0, device="cuda"):
        self.env = env_mod.DroneEnv(task=task, integrator=integrator,
                                    params=params, device=device)
        self.num_envs = int(num_envs)
        self._seed = seed
        self.single_observation_space = spaces.observation_space()
        self.single_action_space = spaces.action_space()
        self.observation_space = _batched(self.single_observation_space,
                                          self.num_envs)
        self.action_space = _batched(self.single_action_space, self.num_envs)
        self._state = None
        self._episode = 0

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        if seed is not None:
            self._seed = seed
            self._episode = 0
        elif self._state is not None:
            # unseeded re-reset: advance every lane's counter-RNG episode
            # stream (gymnasium expects reset() to continue the RNG;
            # replaying init_batch(seed) would score the identical episode
            # set on every eval round)
            self._episode += 1
        self._state = self.env.init_batch(self._seed, self.num_envs,
                                          episode=self._episode)
        return self.env.observe_batch(self._state).cpu().numpy(), {}

    def step(self, actions):
        actions = torch.as_tensor(
            np.asarray(actions, np.float32).reshape(self.num_envs, ACT_DIM),
            device=self.env.device)
        state, out, terminal_obs = env_mod.step_terminal(
            self._state, actions, self.env.params, self.env.statics)
        self._state = state
        host = fetch(out, terminal_obs)
        done = host.terminated | host.truncated
        infos = {}
        if done.any():
            final = np.where(done[:, None], host.terminal_obs, np.nan)
            infos["final_obs"] = final
            infos["final_observation"] = final
            # gymnasium's vector-info convention pairs every key with a
            # "_<key>" mask: one per naming, not just the 1.0 name
            infos["_final_obs"] = done.copy()
            infos["_final_observation"] = done.copy()
            infos["episode_return"] = host.ep_return[done]
            infos["episode_length"] = host.ep_length[done]
        return (host.obs.copy(), host.reward.copy(), host.terminated,
                host.truncated, infos)

    def close(self, **kwargs):
        self._state = None


def make_vector(num_envs: int, task: str = "hover",
                **kwargs) -> DroneVectorGymnasium:
    return DroneVectorGymnasium(num_envs, task=task, **kwargs)
