"""The process group and the runner's lane shards for data-parallel
training (counterpart of `drone_tpu/parallel/mesh.py`).

The reference lays its env batch over a device mesh with one axis, `data`:
each chip steps its own shard of the lanes, parameters and optimizer state
are replicated, and gradients and metrics are averaged over the axis. Here
the mesh is a `torch.distributed` process group, one rank a device: rank r
holds lanes [r * local, (r + 1) * local) of the global batch (the per-lane
fields of the runner: env_state, last_obs and the LSTM carry), and every
rank holds the same parameters and optimizer state. The trainers average a
gradient with one all_reduce (SUM), then a division by the world size held
as a tensor on the device: Gloo has no ReduceOp.AVG, and torch divides a
CUDA tensor by a Python scalar through its reciprocal.

Rank 0 keeps the run's own permutation and noise generators, so a world of
one is the undistributed run bit for bit; rank r > 0 seeds both from
(seed, r), where the reference folds its key with the axis index.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from drone_tpu_torch.types import EnvState, resolve_device

_SHARDED_FIELDS = ("env_state", "last_obs", "carry")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the process group: its world size, its rank, the
    device its tensors live on and the group (None: the default group)."""

    world: int
    rank: int
    device: torch.device
    group: object = None

    def lanes(self, num_envs: int) -> slice:
        """This rank's lanes of a global batch of num_envs."""
        if num_envs % self.world:
            raise ValueError(f"num_envs ({num_envs}) must divide the world "
                             f"size ({self.world})")
        local = num_envs // self.world
        return slice(self.rank * local, (self.rank + 1) * local)


def world_size() -> int:
    """The world size of the default process group, or 1 without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(device="cuda", group=None) -> Mesh:
    """The mesh of this process: the group's world size and rank (1 and 0
    when no group is initialised) and `device` (CUDA's current device when
    no index is given)."""
    d = resolve_device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    if dist.is_available() and dist.is_initialized():
        return Mesh(dist.get_world_size(group), dist.get_rank(group), d,
                    group)
    return Mesh(1, 0, d, group)


def all_sum(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """t summed over the mesh's ranks, in place (t itself without a mesh)."""
    if mesh is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_mean(mesh: Mesh | None, t: torch.Tensor) -> torch.Tensor:
    """t averaged over the mesh's ranks, in place: the sum, divided by the
    world size as a tensor (a fill on the device: no host sync)."""
    if mesh is not None:
        all_sum(mesh, t)
        t.div_(torch.full((), float(mesh.world), dtype=t.dtype,
                          device=t.device))
    return t


def rank_seed(seed: int, rank: int) -> int:
    """The generators' seed of rank `rank` under the run's `seed`: the seed
    itself on rank 0, a draw of numpy's SeedSequence of (seed, rank) on the
    others."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def seed_rank_generators(runner, mesh: Mesh):
    """The runner with its permutation and noise generators seeded for
    this rank (unchanged on rank 0)."""
    if mesh.rank == 0:
        return runner
    seed = rank_seed(runner.generator.initial_seed(), mesh.rank)
    noise = runner.noise_generator
    return dataclasses.replace(
        runner, generator=torch.Generator().manual_seed(seed),
        noise_generator=None if noise is None else torch.Generator(
            device=noise.device).manual_seed(seed))


def take_lanes(x, sl: slice):
    """Lanes `sl` of an EnvState, a tuple of per-lane tensors (the carry) or
    a tensor, copied."""
    if isinstance(x, EnvState):
        return EnvState(**{f.name: getattr(x, f.name)[sl].clone()
                           for f in dataclasses.fields(EnvState)})
    if isinstance(x, tuple):
        return tuple(t[sl].clone() for t in x)
    return x[sl].clone()


def _lane_fields(runner) -> list:
    """The runner's per-lane fields that it holds (a feed-forward runner
    has no carry)."""
    fields = []
    for f in _SHARDED_FIELDS:
        x = getattr(runner, f, None)
        if x is not None and not (isinstance(x, tuple) and not x):
            fields.append(f)
    return fields


def runner_sharding(mesh: Mesh, runner) -> dict:
    """{field: this rank's lanes} for the per-lane fields of a runner built
    for every lane (ppo.RunnerState or ppo_rnn.RecurrentRunnerState: the
    env state, the last obs and, when present, the LSTM carry). The other
    fields (parameters, optimizer state) are replicated."""
    sl = mesh.lanes(runner.env_state.n)
    return {f: sl for f in _lane_fields(runner)}


def place_runner(mesh: Mesh, runner):
    """This rank's shard of a runner built for every lane: its lanes of the
    per-lane fields, the rest as it is, the generators seeded for the
    rank."""
    shards = {f: take_lanes(getattr(runner, f), sl)
              for f, sl in runner_sharding(mesh, runner).items()}
    return seed_rank_generators(dataclasses.replace(runner, **shards), mesh)


def gather_lanes(mesh: Mesh, x):
    """Every rank's lanes of `x` (as take_lanes takes them), concatenated in
    rank order: the global batch, on every rank."""
    def gather(t):
        parts = [torch.empty_like(t) for _ in range(mesh.world)]
        dist.all_gather(parts, t.contiguous(), group=mesh.group)
        return torch.cat(parts)

    if isinstance(x, EnvState):
        return EnvState(**{f.name: gather(getattr(x, f.name))
                           for f in dataclasses.fields(EnvState)})
    if isinstance(x, tuple):
        return tuple(gather(t) for t in x)
    return gather(x)


def gather_runner(mesh: Mesh, runner):
    """(the global runner, the generator states of ranks 1 .. world - 1):
    the lane shards of every rank gathered in rank order beside this rank's
    parameters, optimizer state and generators. Every rank must call it."""
    shards = {f: gather_lanes(mesh, getattr(runner, f))
              for f in _lane_fields(runner)}
    states = [None] * mesh.world
    dist.all_gather_object(
        states, (runner.generator.get_state(),
                 runner.noise_generator.get_state()), group=mesh.group)
    return dataclasses.replace(runner, **shards), states[1:]
