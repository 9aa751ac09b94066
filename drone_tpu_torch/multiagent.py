"""PettingZoo parallel-env surface: the multi-drone swarm adapter.

Counterpart of `drone_tpu/multiagent.py`. The drone simulator is
single-agent physics, so the multi-agent surface is a SWARM: N drones
flying the same task in a shared sky as N PettingZoo agents, stepped as
one batch. The drones do not interact aerodynamically; the adapter's job
is the PettingZoo *API contract*:

  - `agents` shrinks as episodes terminate/truncate (PettingZoo removes
    finished agents), `reset()` restores the full roster;
  - `step(actions)` takes/returns dicts keyed by agent name;
  - per-agent observation/action spaces.

pettingzoo is optional: without it the class is duck-typed with the same
methods (the ParallelEnv base only provides defaults). The swarm runs on
`device`, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch import spaces
from drone_tpu_torch.types import ACT_DIM, EnvParams
from drone_tpu_torch.vector import fetch

try:  # pragma: no cover
    from pettingzoo import ParallelEnv as _ParallelBase
except ImportError:  # pragma: no cover
    _ParallelBase = object


class DroneSwarmParallel(_ParallelBase):
    """N independent drones as a PettingZoo ParallelEnv.

    >>> env = DroneSwarmParallel(n_drones=4)
    >>> obs, infos = env.reset(seed=0)
    >>> acts = {a: env.action_space(a).sample() for a in env.agents}
    >>> obs, rew, term, trunc, infos = env.step(acts)
    """

    metadata = {"name": "drone_swarm_v0", "render_modes": []}

    def __init__(self, n_drones: int = 4, task: str = "hover",
                 integrator: str = "euler", params: EnvParams | None = None,
                 seed: int = 0, device="cuda"):
        self.env = env_mod.DroneEnv(task=task, integrator=integrator,
                                    params=params, device=device)
        self.possible_agents = [f"drone_{i}" for i in range(n_drones)]
        self.agents = []
        self._n = n_drones
        self._seed = seed
        self._obs_space = spaces.observation_space()
        self._act_space = spaces.action_space()
        self._state = None
        self._episode = 0

    def observation_space(self, agent):
        return self._obs_space

    def action_space(self, agent):
        return self._act_space

    def reset(self, seed=None, options=None):
        if seed is not None:
            self._seed = seed
            self._episode = 0
        elif self._state is not None:
            # unseeded re-reset: fresh episodes via the counter-RNG episode
            # stream, not a byte-identical replay of the same batch
            self._episode += 1
        self.agents = list(self.possible_agents)
        self._state = self.env.init_batch(self._seed, self._n,
                                          episode=self._episode)
        obs = self.env.observe_batch(self._state).cpu().numpy()
        return ({a: obs[i] for i, a in enumerate(self.possible_agents)},
                {a: {} for a in self.possible_agents})

    def step(self, actions):
        if not self.agents:
            raise RuntimeError("no live agents — call reset()")
        # inactive lanes get zero actions; their results are not reported
        # and their state is irrelevant until the next reset
        full = np.zeros((self._n, ACT_DIM), np.float32)
        for i, a in enumerate(self.possible_agents):
            if a in actions:
                full[i] = np.asarray(actions[a], np.float32).reshape(ACT_DIM)
        state, out, terminal_obs = env_mod.step_terminal(
            self._state, torch.as_tensor(full, device=self.env.device),
            self.env.params, self.env.statics)
        self._state = state
        host = fetch(out, terminal_obs)

        obs, rew, term, trunc, infos = {}, {}, {}, {}, {}
        live = set(self.agents)
        still = []
        for i, a in enumerate(self.possible_agents):
            if a not in live:
                continue
            done = bool(host.terminated[i]) or bool(host.truncated[i])
            # PettingZoo: terminal observation on the done step
            obs[a] = (host.terminal_obs[i] if done else host.obs[i]).copy()
            rew[a] = float(host.reward[i])
            term[a] = bool(host.terminated[i])
            trunc[a] = bool(host.truncated[i])
            infos[a] = ({"episode": {"r": float(host.ep_return[i]),
                                     "l": int(host.ep_length[i])}}
                        if done else {})
            if not done:
                still.append(a)
        self.agents = still
        return obs, rew, term, trunc, infos

    def render(self):
        return None

    def close(self):
        self._state = None
        self.agents = []


def make_swarm(n_drones: int = 4, task: str = "hover",
               **kwargs) -> DroneSwarmParallel:
    return DroneSwarmParallel(n_drones=n_drones, task=task, **kwargs)
