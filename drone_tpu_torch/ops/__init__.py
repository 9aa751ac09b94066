"""Hand-written CUDA kernels for the hot paths, each beside its plain
PyTorch version (counterpart of `drone_tpu.ops`)."""

from drone_tpu_torch.ops.cuda_rollout import rollout_cuda  # noqa: F401
from drone_tpu_torch.ops.cuda_acting import act_rollout_cuda  # noqa: F401
from drone_tpu_torch.ops.cuda_acting_traj import traj_rollout_cuda  # noqa: F401
from drone_tpu_torch.ops.cuda_update import (  # noqa: F401
    fused_adam_cuda,
    ppo_update_cuda,
)
from drone_tpu_torch.ops.cuda_acting_lstm import (  # noqa: F401
    lstm_act_rollout_cuda,
    traj_lstm_rollout_cuda,
)
from drone_tpu_torch.ops.cuda_update_lstm import lstm_update_cuda  # noqa: F401
from drone_tpu_torch.ops.cuda_update_cnn import ppo_cnn_update_cuda  # noqa: F401
from drone_tpu_torch.ops.cuda_acting_cnn import (  # noqa: F401
    cnn_act_rollout_cuda,
    traj_cnn_rollout_cuda,
)
