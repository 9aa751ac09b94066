"""Process-group bootstrap and the runner built one shard a rank
(counterpart of `drone_tpu/parallel/multihost.py`).

The reference bootstraps with `jax.distributed.initialize` and builds each
host's shards with a jitted initializer. Here `initialize_multihost` starts
a `torch.distributed` process group, from explicit arguments or from the
environment torchrun sets, and `global_init_runner` builds only the rank's
lanes: lane l of rank r is bitwise lane r * local + l of the unsharded
batch, since every lane's episode draws are keyed on its global lane id.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from drone_tpu_torch.parallel.mesh import Mesh, make_mesh, seed_rank_generators
from drone_tpu_torch.types import resolve_device


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         device="cuda") -> Mesh:
    """Start the process group and return this process's mesh on `device`.

    coordinator_address "host:port" of rank 0, with num_processes and
    process_id; with none of them, torchrun's RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT and LOCAL_RANK. backend: "nccl" when `device` is CUDA and
    "gloo" otherwise, unless named. On CUDA with no index given, each rank
    takes cuda:LOCAL_RANK (with explicit arguments cuda:(process_id % the
    device count), so ranks share the cards of a host in turn); a CPU run
    touches no card."""
    local_rank = None
    if coordinator_address is None:
        process_id = int(os.environ["RANK"])
        num_processes = int(os.environ["WORLD_SIZE"])
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    d = resolve_device(device)
    if backend is None:
        backend = "nccl" if d.type == "cuda" else "gloo"
    if d.type == "cuda":
        if d.index is None:
            if local_rank is None:
                local_rank = process_id % torch.cuda.device_count()
            d = torch.device("cuda", local_rank)
        torch.cuda.set_device(d)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return make_mesh(d)


def global_init_runner(init_fn, mesh: Mesh, num_envs: int):
    """This rank's runner of a global batch of num_envs lanes, built for
    its lanes alone: init_fn(first_lane=..., num_envs=local) -> runner (for
    example ppo.init_runner with the local lane count), with the
    generators seeded for the rank."""
    sl = mesh.lanes(num_envs)
    runner = init_fn(first_lane=sl.start, num_envs=sl.stop - sl.start)
    return seed_rank_generators(runner, mesh)
