"""The data-parallel train step: every trainer tier on the rank's lane
shard (counterpart of `drone_tpu/parallel/train_sharded.py`).

The reference wraps a trainer in shard_map over the mesh, its collectives
inside the step under `axis_name`. Here each trainer takes the mesh itself
and runs its collectives (`parallel.mesh.all_sum`, `all_mean`) where the
reference's pmean and psum stand: the global mean and variance of the
advantages, the gradient between the update kernel (or autograd) and K4,
so that K4 clips the averaged gradient, and the episode statistics (summed)
and metrics (averaged) of the update.
"""

from __future__ import annotations

import dataclasses

_TRAINERS = ("scan", "pallas", "pallas_rollout")


def make_sharded_train_step(model, env, cfg, mesh, trainer: str = "scan",
                            recurrent: bool = False, policy: str = "mlp",
                            compute_dtype: str = "float32"):
    """Returns train_step(runner) -> (runner, metrics) of this rank's shard.

    cfg.num_envs is the GLOBAL lane count; each rank steps num_envs / world
    lanes (its runner built by `multihost.global_init_runner` or
    `mesh.place_runner`). Parameters stay replicated: every rank applies
    the same averaged gradient. mesh None runs the undistributed trainer.

    trainer "pallas" is the megakernel trainer of the family
    (`ppo_cuda.make_train_step`, `ppo_cnn_cuda.make_cnn_train_step` for
    policy="cnn", `ppo_rnn_cuda.make_rnn_train_step` with recurrent=True;
    compute_dtype their products), "pallas_rollout" with recurrent=True the
    hybrid tier (K6's rollout, the autograd update), "scan" the scan
    trainer (`ppo.make_train_step`, `ppo_rnn.make_recurrent_train_step`).
    `model` fixes the scan trainers' family."""
    if trainer not in _TRAINERS:
        raise ValueError(
            f"trainer must be 'scan', 'pallas' or 'pallas_rollout', got "
            f"{trainer!r} (a typo would silently fall through to the scan "
            f"trainer and misattribute throughput)")
    if trainer == "pallas_rollout" and not recurrent:
        raise ValueError(
            "trainer='pallas_rollout' is the recurrent hybrid tier "
            "(LSTM rollout kernel + autograd update); for the MLP megakernel "
            "trainer use trainer='pallas'")
    world = 1 if mesh is None else mesh.world
    if cfg.num_envs % world:
        raise ValueError(f"num_envs ({cfg.num_envs}) must divide the mesh "
                         f"size ({world})")
    local = dataclasses.replace(cfg, num_envs=cfg.num_envs // world)
    # imported here: the trainers import parallel.mesh
    if trainer == "pallas" and recurrent:
        from drone_tpu_torch import ppo_rnn_cuda

        return ppo_rnn_cuda.make_rnn_train_step(
            env, local, compute_dtype=compute_dtype, mesh=mesh)
    if recurrent:
        from drone_tpu_torch import ppo_rnn

        return ppo_rnn.make_recurrent_train_step(
            model, env, local,
            rollout="pallas" if trainer == "pallas_rollout" else "scan",
            mesh=mesh)
    if trainer == "pallas" and policy == "cnn":
        from drone_tpu_torch import ppo_cnn_cuda

        return ppo_cnn_cuda.make_cnn_train_step(
            env, local, compute_dtype=compute_dtype, mesh=mesh)
    if trainer == "pallas":
        from drone_tpu_torch import ppo_cuda

        return ppo_cuda.make_train_step(env, local,
                                        compute_dtype=compute_dtype,
                                        mesh=mesh)
    from drone_tpu_torch import ppo

    return ppo.make_train_step(model, env, local, mesh=mesh)
