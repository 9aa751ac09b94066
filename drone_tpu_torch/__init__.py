"""drone_tpu_torch — the PyTorch and CUDA port of drone_tpu.

The JAX package `drone_tpu` stays the reference; this package imports
neither it nor JAX. Plain tensor code is PyTorch; every Pallas kernel of
the reference becomes a hand-written CUDA kernel under `csrc/`, built with
nvcc at first use and bound with ctypes (`ops/cuda_build.py`). Each kernel
wrapper keeps a plain PyTorch version beside it, which runs for CPU
tensors; on a CUDA tensor the wrapper launches the kernel or raises.

Module map (same names as `drone_tpu`):
  types, prng, mixing, dynamics, tasks, randomize, env   the env, bitwise
                                                          to the C oracle
  rollout                 batched Python-loop rollouts
  spaces, vector, emulation, multiagent
                          the env adapters: Box spaces, the vecenv, the
                          Gymnasium envs, the PettingZoo swarm
  ops.cuda_rollout        env megakernel (K1) + its plain version
  ops.cuda_acting         MLP acting megakernel (K5) + its plain version
  ops.cuda_acting_traj    trajectory rollout kernel (K2) + its plain version
  ops.cuda_update         PPO update (K3) and fused clip+adam (K4) + theirs
  ops.cuda_acting_lstm    LSTM acting (K8) and trajectory rollout (K6),
                          dense and CNN-encoder arms
  ops.cuda_update_lstm    truncated-BPTT PPO update (K7), both arms
  ops.cuda_acting_cnn     patch-CNN acting (K11) and trajectory rollout (K9)
  ops.cuda_update_cnn     patch-CNN PPO update (K10)
  models.mlp, models.lstm, models.cnn
                          ActorCritic, LSTMActorCritic, CNNLSTMActorCritic,
                          PatchCNNActorCritic, PatchCNNEncoder (flat
                          parameter buffers) and the flax weight and
                          optimizer-state converters
  models.export           DRNW export for the C runtime (native/dronenet.c)
  pixels                  the splat render and the pixel-grid table
  ppo, ppo_cuda           GAE, RunnerState; the MLP megakernel PPO trainer
  ppo_rnn, ppo_rnn_cuda   RecurrentRunnerState; the recurrent megakernel
                          trainer (lstm and cnn_lstm)
  ppo_cnn_cuda            the patch-CNN megakernel trainer
  sweep, autotune         the hyperparameter sweep, the batch-shape tuner
  viewer                  `cli watch`'s one-lane rollout to CSV
  parallel                torch.distributed: lane shards over a process
                          group, the sharded train step of every trainer,
                          torchrun bootstrap, weak scaling
  ops.sharded             K1 and K5 on a rank's lanes
  utils.config, utils.checkpoint, utils.metrics, train (train, evaluate),
  cli (train, eval, bench, sweep, export, autotune, watch)
"""

__version__ = "0.1.0"

from drone_tpu_torch.types import EnvParams, EnvState, EnvStatics, StepOut  # noqa: F401
from drone_tpu_torch.env import DroneEnv  # noqa: F401
