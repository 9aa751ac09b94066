"""Evaluation driver: restore a policy and roll it out in the env.

Counterpart of `drone_tpu/train.py` for the serving path (`evaluate`,
`build_env_and_model`, `restore_dir`). Training is still to port
(ROADMAP.md, "the training slice").
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

from drone_tpu_torch.env import DroneEnv
from drone_tpu_torch.models import ActorCritic
from drone_tpu_torch.ops import act_rollout_cuda
from drone_tpu_torch.rollout import rollout_policy
from drone_tpu_torch.types import resolve_device
from drone_tpu_torch.utils.checkpoint import Checkpointer
from drone_tpu_torch.utils.config import Config

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_UNPORTED_POLICIES = {
    "lstm": "the LSTM family",
    "cnn_lstm": "the LSTM family",
    "cnn": "the pixel families",
    "cnn_overlap": "the pixel families",
}


def build_env_and_model(cfg: Config, device="cuda"):
    """Config -> (env, model) on `device`: the one policy-model switch."""
    device = resolve_device(device)
    statics, params = cfg.env.build()
    env = DroneEnv(task=statics.task, integrator=statics.integrator,
                   params=params, device=device)
    if cfg.run.policy in _UNPORTED_POLICIES:
        raise NotImplementedError(
            f"run.policy={cfg.run.policy!r} is not ported yet (ROADMAP.md, "
            f"module queue: {_UNPORTED_POLICIES[cfg.run.policy]})")
    if cfg.run.policy != "mlp":
        raise ValueError(f"run.policy must be 'mlp', 'cnn', 'cnn_overlap', "
                         f"'lstm' or 'cnn_lstm', got {cfg.run.policy!r}")
    model = ActorCritic(hidden=tuple(cfg.run.hidden),
                        dtype=_DTYPES[cfg.run.compute_dtype], device=device)
    return env, model


def restore_dir(cfg: Config) -> Path:
    """Where eval restores from: run.resume_from when set, else the run's
    own checkpoint dir."""
    if cfg.run.resume_from:
        return Path(cfg.run.resume_from)
    return Path(cfg.run.checkpoint_dir) / cfg.run.run_name / "checkpoints"


def _episode_stats(stats) -> dict:
    n_ep = float(stats["episodes"])
    mean = float(stats["ep_return_sum"]) / max(n_ep, 1.0)
    var = float(stats["ep_return_sq_sum"]) / max(n_ep, 1.0) - mean * mean
    return {
        "episodes": int(n_ep),
        "ep_return_mean": mean,
        "ep_return_std": float(max(var, 0.0) ** 0.5),
        "ep_length_mean": float(stats["ep_length_sum"]) / max(n_ep, 1.0),
    }


@torch.no_grad()
def evaluate(cfg: Config, runner=None, episodes: int = 64, deterministic=True,
             device="cuda") -> dict:
    """Roll out the restored (or given: `runner.params`, a state dict or an
    ActorCritic) policy for horizon + 1 steps on `episodes` lanes and report
    episode stats. A deterministic float32 MLP policy goes through the
    acting kernel (K5; its plain version on the CPU)."""
    env, model = build_env_and_model(cfg, device)
    if runner is None:
        raw, _ = Checkpointer(restore_dir(cfg)).restore_raw()
        params = raw["params"]
    else:
        params = runner.params
    if isinstance(params, nn.Module):
        params = params.state_dict()
    model.load_state_dict(params)
    model.eval()

    n = episodes
    state = env.init_batch(cfg.run.seed + 1, n)
    horizon = int(env.params.horizon) + 1

    # the kernel computes in float32: a bf16-trained policy is a slightly
    # different function, so it goes through the module with its dtype
    if deterministic and cfg.run.compute_dtype == "float32":
        _, stats = act_rollout_cuda(state, model, env.params, env.statics,
                                    horizon)
        return _episode_stats(stats)

    def policy(obs, generator):
        mean, log_std, _ = model(obs)
        if deterministic:
            return mean, ()
        noise = torch.randn(mean.shape, generator=generator,
                            device=mean.device)
        return mean + torch.exp(log_std) * noise, ()

    generator = torch.Generator(device=env.device).manual_seed(0)
    _, (out, _) = rollout_policy(state, policy, horizon, env.params,
                                 env.statics, generator=generator)
    done = (out.terminated | out.truncated).cpu().numpy()
    rets = out.ep_return.cpu().numpy()[done]
    lens = out.ep_length.cpu().numpy()[done]
    return {
        "episodes": int(done.sum()),
        "ep_return_mean": float(rets.mean()) if rets.size else float("nan"),
        "ep_return_std": float(rets.std()) if rets.size else float("nan"),
        "ep_length_mean": float(lens.mean()) if lens.size else float("nan"),
    }
