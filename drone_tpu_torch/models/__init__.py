"""Policies: counterpart of `drone_tpu.models` (the MLP family so far)."""

from drone_tpu_torch.models.mlp import (  # noqa: F401
    ActorCritic,
    fused_opt_state_from_flax,
    fused_opt_state_to_flax,
    kernel_offsets,
    kernel_order,
    params_from_flax,
    params_to_flax,
)
