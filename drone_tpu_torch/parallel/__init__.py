"""Data-parallel training over `torch.distributed` (counterpart of
`drone_tpu/parallel/`): the env batch split in lane shards over the ranks
of a process group, gradients averaged by all_reduce, multi-process
bootstrap from torchrun's environment or explicit arguments.
"""

from drone_tpu_torch.parallel.mesh import make_mesh, runner_sharding  # noqa: F401
from drone_tpu_torch.parallel.train_sharded import make_sharded_train_step  # noqa: F401
