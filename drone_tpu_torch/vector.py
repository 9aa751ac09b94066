"""Numpy-facing vectorized env API: the reference's vecenv surface.

Counterpart of `drone_tpu/vector.py`: `make(task, num_envs, backend)`
returns a vecenv with the sync `reset/step` and the async
`async_reset/send/recv` over preallocated, caller-visible numpy buffers,
including the envpool-style PARTIAL-BATCH protocol (batch_size <
num_envs): the fleet is split into num_envs/batch_size sub-batches, each
in flight on its own; recv() returns the next completed sub-batch (with
its env_ids), send(actions) queues the step of the sub-batch just received.
On the card the "workers" are the CUDA stream: steps queued by send() run
while the host goes on, and recv() waits for the sub-batch it returns.

  - backend="jit"    one batched step over the lane axis (the plain env on
                     the device); the numpy buffers are filled by one
                     device-to-host copy per recv.
  - backend="serial" a Python loop of one-lane steps, the reference's
                     debug backend; its batches are bitwise those of "jit"
                     (the env computes each lane on its own, with no
                     transcendental and no reduction across lanes).

send() never waits for the card: it copies the actions through a pinned
host buffer with non_blocking=True and queues the step. A buffer is
written again only after the recv() that followed its copy, whose
device-to-host copy waited for the stream. Training should use the
trainers (`drone_tpu_torch.train`); this facade exists for evaluation,
demos and users who expect the vecenv surface.
"""

from __future__ import annotations

import collections
import types

import numpy as np
import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch import spaces
from drone_tpu_torch.types import ACT_DIM, OBS_DIM, EnvParams, EnvState

BACKENDS = ("jit", "serial")


def fetch(out, terminal_obs=None):
    """A StepOut (and the terminal observations) on the host in ONE
    device-to-host copy: every field packed into one float32 tensor (the
    bools as 0/1, ep_length's int32 bits as they are), then unpacked into
    numpy arrays with the StepOut's field names."""
    cols = [out.obs, out.reward[:, None],
            out.terminated[:, None].to(torch.float32),
            out.truncated[:, None].to(torch.float32),
            out.ep_return[:, None], out.ep_length.view(torch.float32)[:, None]]
    if terminal_obs is not None:
        cols.append(terminal_obs)
    host = torch.cat(cols, 1).cpu().numpy()
    o = OBS_DIM
    return types.SimpleNamespace(
        obs=host[:, :o], reward=host[:, o], terminated=host[:, o + 1] != 0,
        truncated=host[:, o + 2] != 0, ep_return=host[:, o + 3],
        ep_length=np.ascontiguousarray(host[:, o + 4]).view(np.int32),
        terminal_obs=host[:, o + 5:] if terminal_obs is not None else None)


def lane_slice(state: EnvState, lo: int, hi: int) -> EnvState:
    """Lanes lo..hi-1 of a batched state."""
    return EnvState(**{k: v[lo:hi] for k, v in vars(state).items()})


def lane_cat(states):
    """Batched states (or StepOuts) joined along the lane axis."""
    cls = type(states[0])
    return cls(**{k: torch.cat([vars(s)[k] for s in states])
                  for k in vars(states[0])})


class VecDrone:
    """Vectorized drone env over `num_envs` lanes with caller-visible numpy
    buffers (observations/rewards/terminals/truncations), PufferEnv-style.
    The env runs on `device` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, num_envs: int, task: str = "hover",
                 integrator: str = "euler", params: EnvParams | None = None,
                 backend: str = "jit", seed: int = 0,
                 batch_size: int | None = None, device="cuda"):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.env = env_mod.DroneEnv(task=task, integrator=integrator,
                                    params=params, device=device)
        self.device = self.env.device
        self.num_envs = int(num_envs)
        self.backend = backend
        self.seed = seed
        self.batch_size = int(batch_size) if batch_size else self.num_envs
        if self.num_envs % self.batch_size:
            raise ValueError(f"batch_size ({self.batch_size}) must divide "
                             f"num_envs ({self.num_envs})")
        self._n_sub = self.num_envs // self.batch_size

        self.single_observation_space = spaces.observation_space()
        self.single_action_space = spaces.action_space()

        # caller-visible preallocated buffers; in partial-batch mode they
        # hold ONE sub-batch and recv() reports which lanes via
        # infos["env_ids"]
        nb = self.batch_size
        self.observations = np.zeros((nb, OBS_DIM), np.float32)
        self.rewards = np.zeros(nb, np.float32)
        self.terminals = np.zeros(nb, bool)
        self.truncations = np.zeros(nb, bool)
        # one pinned action buffer per sub-batch, each reused only after
        # its sub-batch's recv()
        pin = self.device.type == "cuda"
        self._actions = [torch.empty((nb, ACT_DIM), dtype=torch.float32,
                                     pin_memory=pin)
                         for _ in range(self._n_sub)]

        self._state = None          # device EnvState, batched
        self._pending = None        # in-flight (state, StepOut) from send()
        self._subs = None           # partial mode: per-sub-batch EnvStates
        self._queue = None          # partial mode: FIFO of in-flight subs
        self._awaiting = None       # partial mode: sub id last recv'd

    def _step_fn(self, state: EnvState, actions: torch.Tensor):
        p, statics = self.env.params, self.env.statics
        if self.backend == "jit":
            return env_mod.step(state, actions, p, statics)
        steps = [env_mod.step(lane_slice(state, i, i + 1), actions[i:i + 1],
                              p, statics) for i in range(actions.shape[0])]
        return (lane_cat([s for s, _ in steps]),
                lane_cat([o for _, o in steps]))

    def _upload(self, actions, slot: int) -> torch.Tensor:
        """The actions on the env's device, queued without a wait."""
        buf = self._actions[slot]
        buf.numpy()[:] = np.asarray(actions, np.float32).reshape(
            self.batch_size, ACT_DIM)
        if self.device.type == "cpu":
            return buf.clone()
        return buf.to(self.device, non_blocking=True)

    def _fill(self, host):
        self.observations[:] = host.obs
        self.rewards[:] = host.reward
        self.terminals[:] = host.terminated
        self.truncations[:] = host.truncated
        done = self.terminals | self.truncations
        infos = {}
        if done.any():
            infos["episode_return"] = host.ep_return[done]
            infos["episode_length"] = host.ep_length[done]
            infos["finished"] = done
        return infos

    def _fill_reset(self, state: EnvState):
        self.observations[:] = env_mod.observe(state).cpu().numpy()
        self.rewards[:] = 0.0
        self.terminals[:] = False
        self.truncations[:] = False

    # -- sync API ------------------------------------------------------------
    def reset(self, seed: int | None = None):
        """-> (observations, infos). Buffers are (re)filled in place."""
        if self._n_sub > 1:
            raise RuntimeError(
                "batch_size < num_envs is async-only: use async_reset()/"
                "send()/recv() (the reference's envpool protocol)")
        if seed is not None:
            self.seed = seed
        self._pending = None  # drop any in-flight step from before the reset
        self._state = self.env.init_batch(self.seed, self.num_envs)
        self._fill_reset(self._state)
        return self.observations, {}

    def step(self, actions):
        """-> (obs, rewards, terminals, truncations, infos); auto-reset lanes
        return the NEW episode's first obs (PufferEnv convention)."""
        self.send(actions)
        return self.recv()

    # -- async API (the reference's envpool-style double buffering) ----------
    def async_reset(self, seed: int | None = None):
        """Arms pending reset results: the canonical calling loop is
        async_reset() -> recv() (initial obs + env_ids) -> send(actions)
        -> recv() ... With batch_size < num_envs every sub-batch is queued
        and up to num_envs/batch_size steps are in flight at once."""
        if self._n_sub == 1:
            self.reset(seed)
            self._pending = "reset"
            return
        if seed is not None:
            self.seed = seed
        full = self.env.init_batch(self.seed, self.num_envs)
        nb = self.batch_size
        self._subs = [lane_slice(full, i * nb, (i + 1) * nb)
                      for i in range(self._n_sub)]
        self._queue = collections.deque(
            ("reset", i, None) for i in range(self._n_sub))
        self._awaiting = None

    def send(self, actions):
        """Queue one step; never waits for the card."""
        if self._n_sub > 1:
            if self._awaiting is None:
                raise RuntimeError("send() without a recv'd sub-batch")
            i = self._awaiting
            self._awaiting = None
            pending = self._step_fn(self._subs[i], self._upload(actions, i))
            self._queue.append(("step", i, pending))
            return
        if self._state is None:
            raise RuntimeError("call reset()/async_reset() before send()")
        if self._pending == "reset":
            self._pending = None  # caller skipped recv'ing the initial obs
        if self._pending is not None:
            raise RuntimeError("send() called twice without recv()")
        self._pending = self._step_fn(self._state, self._upload(actions, 0))

    def recv(self):
        if self._n_sub > 1:
            return self._recv_sub()
        if self._pending is None:
            raise RuntimeError("recv() called without a pending send()")
        if self._pending == "reset":
            self._pending = None
            return (self.observations, self.rewards, self.terminals,
                    self.truncations, {})
        state, out = self._pending
        self._pending = None
        self._state = state
        infos = self._fill(fetch(out))
        return (self.observations, self.rewards, self.terminals,
                self.truncations, infos)

    def _recv_sub(self):
        """Partial-batch recv: the next completed sub-batch, in FIFO order
        (one stream completes its work in order)."""
        if not self._queue:
            raise RuntimeError("recv() with no sub-batch in flight — call "
                               "async_reset()/send() first")
        if self._awaiting is not None:
            raise RuntimeError("recv() called twice without send()")
        kind, i, payload = self._queue.popleft()
        nb = self.batch_size
        infos = {"env_ids": np.arange(i * nb, (i + 1) * nb)}
        if kind == "reset":
            self._fill_reset(self._subs[i])
        else:
            state, out = payload
            self._subs[i] = state
            infos.update(self._fill(fetch(out)))
        self._awaiting = i
        return (self.observations, self.rewards, self.terminals,
                self.truncations, infos)

    def close(self):
        self._state = None
        self._pending = None
        self._subs = None
        self._queue = None
        self._awaiting = None

    @property
    def observation_space(self):
        return self.single_observation_space

    @property
    def action_space(self):
        return self.single_action_space


def make(task: str = "hover", num_envs: int = 8, *, integrator: str = "euler",
         params: EnvParams | None = None, backend: str = "jit",
         seed: int = 0, batch_size: int | None = None,
         device="cuda") -> VecDrone:
    """The reference's `pufferlib.vector.make` analogue (batch_size <
    num_envs selects the envpool-style partial-batch async protocol)."""
    return VecDrone(num_envs, task=task, integrator=integrator,
                    params=params, backend=backend, seed=seed,
                    batch_size=batch_size, device=device)
