"""Learning gate of the port's megakernel trainer on the CPU (the plain
versions of K2, K3 and K4), the gate of the reference's
`test_fused_trainer_learns`: 512 envs, horizon 32, [32, 32], lr 3e-3, no
entropy bonus. Within 80 updates the mean reward of the last 5 updates must
exceed that of the first 5 by 0.2, and 0.3 in absolute terms.
"""

import numpy as np
import pytest
import torch

from drone_tpu_torch import ppo_cuda
from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import ActorCritic
from drone_tpu_torch.ppo import PPOConfig, init_runner


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_megakernel_trainer_learns_hover():
    env = tenv.DroneEnv(device="cpu")
    cfg = PPOConfig(horizon=32, num_envs=512, epochs=4, num_minibatches=4,
                    lr=3e-3, ent_coef=0.0)
    model = ActorCritic((32, 32), generator=torch.Generator().manual_seed(0))
    runner = init_runner(model, env, cfg, seed=0)
    step = ppo_cuda.make_train_step(env, cfg)
    rewards = []
    for _ in range(80):
        runner, m = step(runner)
        rewards.append(float(m["reward_mean"]))
    assert np.mean(rewards[-5:]) > np.mean(rewards[:5]) + 0.2
    assert np.mean(rewards[-5:]) > 0.3
