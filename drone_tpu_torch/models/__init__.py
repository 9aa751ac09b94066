"""Policies: counterpart of `drone_tpu.models` (the MLP family so far)."""

from drone_tpu_torch.models.mlp import (  # noqa: F401
    ActorCritic,
    params_from_flax,
    params_to_flax,
)
