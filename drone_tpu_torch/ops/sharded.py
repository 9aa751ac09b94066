"""The env engine (K1) and the MLP acting kernel (K5) over the ranks of a
process group (counterpart of `drone_tpu/ops/sharded.py`).

Each rank runs the kernel on its own lane shard (the kernels are lane
parallel; nothing crosses lanes) and the episode statistics are summed over
the group in one all_reduce. The reference device_puts a global batch and
caches a jitted shard_map per configuration; here each rank holds only its
lanes (`DroneEnv.init_batch(seed, local, first_lane=rank * local)`, or
`parallel.mesh.take_lanes` of a global batch), and there is nothing to
cache.
"""

from __future__ import annotations

import torch

from drone_tpu_torch.ops.cuda_acting import act_rollout_cuda
from drone_tpu_torch.ops.cuda_rollout import rollout_cuda
from drone_tpu_torch.parallel.mesh import Mesh, all_sum
from drone_tpu_torch.types import EnvParams, EnvState, EnvStatics

_STATS = ("reward_sum", "episodes", "ep_return_sum", "ep_length_sum",
          "ep_return_sq_sum")


def _summed(mesh: Mesh, stats: dict) -> dict:
    sums = all_sum(mesh, torch.stack([stats[k] for k in _STATS]))
    return dict(zip(_STATS, sums))


def sharded_rollout_cuda(mesh: Mesh, state: EnvState, params: EnvParams,
                         statics: EnvStatics, T: int, actions=None):
    """rollout_cuda (K1) on this rank's lanes `state`. Returns (the rank's
    final state, the stats dict summed over every rank)."""
    final, stats = rollout_cuda(state, params, statics, T, actions)
    return final, _summed(mesh, stats)


def sharded_act_rollout_cuda(mesh: Mesh, state: EnvState, policy,
                             env_params: EnvParams, statics: EnvStatics,
                             T: int, stochastic: bool = False):
    """act_rollout_cuda (K5, the fused policy and env) on this rank's lanes
    `state`. Returns (the rank's final state, the stats dict summed over
    every rank)."""
    final, stats = act_rollout_cuda(state, policy, env_params, statics, T,
                                    stochastic)
    return final, _summed(mesh, stats)
