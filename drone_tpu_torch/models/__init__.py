"""Policies: counterpart of `drone_tpu.models` (the MLP, LSTM, patch-CNN,
overlapping-conv CNN and pixel-recurrent CNN-LSTM families, and the DRNW
export for the C runtime)."""

from drone_tpu_torch.models.mlp import (  # noqa: F401
    ActorCritic,
    fused_opt_state_from_flax,
    fused_opt_state_to_flax,
    kernel_offsets,
    kernel_order,
    order_offsets,
    params_from_flax,
    params_to_flax,
    tensor_sizes,
)
from drone_tpu_torch.models.lstm import (  # noqa: F401
    CNNLSTMActorCritic,
    LSTMActorCritic,
    lstm_kernel_offsets,
    lstm_kernel_order,
)
from drone_tpu_torch.models.cnn import (  # noqa: F401
    CNNActorCritic,
    CnnArch,
    CnnGeom,
    PatchCNNActorCritic,
    PatchCNNEncoder,
    PixelActorCritic,
    cnn_kernel_offsets,
    cnn_kernel_order,
    conv_params_from_flax,
    conv_params_to_flax,
)
from drone_tpu_torch.models.export import (  # noqa: F401
    export_flat_weights,
    load_flat_weights,
)
