"""Recurrent megakernel PPO: the LSTM rollout and the truncated-BPTT update
in hand-written kernels.

Counterpart of `drone_tpu/ppo_rnn_pallas.py` with the fused optimizer
(`make_pallas_rnn_train_step(..., fused_optimizer=True)`):

  rollout   - K6 (ops/cuda_acting_lstm.py) streams the (T, 21, N) planes
              and the (c, h) anchor entering every bptt segment, policy and
              env fused, exploration noise from the lanes' counter streams;
  GAE       - ppo_cuda's, with the bootstrap value of the last obs at the
              last carry (`ops.cuda_acting_lstm.lstm_value`, the
              reference's `_lstm_value`, through the policy's encoder);
  update    - K7 (ops/cuda_update_lstm.py) per minibatch: row blocks of
              whole lanes, each bptt segment re-run from its anchor and
              walked backward through time;
  optimizer - K4 (ops/cuda_update.py) over the LSTM's flat buffer.

Both recurrent families train here: `arch` = (hidden, encoder) carries
the encoder kind, the dense widths (run.policy=lstm) or the patch-CNN
tower's CnnArch (run.policy=cnn_lstm, whose flat buffer holds 23 tensors),
and K6, K7 and the last value take the matching arm.

`compute_dtype` "bfloat16" runs K7's bf16 operand arm, and K7's only, as
the reference's `make_pallas_rnn_train_step` applies it to the update
kernel alone: K6 rolls out in float32 (`ppo_rnn_pallas.py:191-193`) and
GAE's last value is the float32 forward (its `_lstm_value` takes no
dtype), so the first minibatch's ratios already differ from 1.

The trainer scaffolding (minibatch geometry, advantage normalization, the
losses from the stat sums, the epoch loop, the metrics, the permutations)
is ppo_cuda's. As there, the one deliberate change from the reference: the
permutations come from the runner's CPU `torch.Generator`. The update runs
in place on the runner's buffers and waits for the host nowhere.
"""

from __future__ import annotations

import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.models.lstm import lstm_weights
from drone_tpu_torch.models.mlp import tensor_sizes
from drone_tpu_torch.ops.cuda_acting_lstm import (
    lstm_value,
    traj_lstm_rollout_cuda,
)
from drone_tpu_torch.ops.cuda_acting_traj import bf16_flag
from drone_tpu_torch.ops.cuda_update import (
    N_UPSTATS,
    AdamConsts,
    fused_adam_cuda,
)
from drone_tpu_torch.ops.cuda_update_lstm import lstm_update_cuda
from drone_tpu_torch.parallel.mesh import all_mean
from drone_tpu_torch.ppo import PPOConfig
from drone_tpu_torch.ppo_cuda import (
    entropies,
    make_fused_lr,
    make_losses,
    normalized_advret,
    plan_minibatch_geometry,
    run_epoch_scans,
    trainer_metrics,
    update_permutations,
)
from drone_tpu_torch.ppo_rnn import RecurrentRunnerState, bptt_of


def make_rnn_train_step(env, cfg: PPOConfig, permutations=None,
                        on_phase=None, compute_dtype: str = "float32",
                        mesh=None):
    """Build the recurrent megakernel train step: RecurrentRunnerState ->
    (RecurrentRunnerState, metrics), with the env's params and device.
    permutations, on_phase and mesh as in ppo_cuda.make_train_step;
    compute_dtype ("float32" or "bfloat16", ValueError for another) the
    update kernel's products."""
    bf16_flag(compute_dtype)
    bptt = bptt_of(cfg)
    _, _, rbu, n_rb, mb_rb, co = plan_minibatch_geometry(cfg, cfg.num_envs)
    rbl = rbu * 128
    ac = AdamConsts(clip_norm=cfg.max_grad_norm)
    sched = make_fused_lr(cfg)
    losses_fn = make_losses(cfg, co)
    n_steps = cfg.epochs * cfg.num_minibatches
    mark = on_phase or (lambda name: None)

    def train_step(runner: RecurrentRunnerState):
        mark("rollout")
        model = runner.params
        theta = getattr(model, "flat", None)
        if theta is None:
            raise ValueError("the model's parameters are not flat: call "
                             "LSTMActorCritic.flatten_() "
                             "(init_recurrent_runner does)")
        arch = (model.hidden, model.encoder)
        sizes = tensor_sizes(model.kernel_order())
        count, mu, nu = runner.opt_state
        dev = theta.device
        if runner.env_state.n != cfg.num_envs:
            raise ValueError(f"the runner has {runner.env_state.n} lanes, "
                             f"the config {cfg.num_envs}")
        perms = update_permutations(runner, permutations, cfg, n_rb, dev)

        # --- rollout: planes (T, 21, N) and anchors (S, 2, H, N) -----------
        final, last_carry, planes, snap, stats = traj_lstm_rollout_cuda(
            runner.env_state, theta, arch, runner.carry, env.params,
            env.statics, cfg.horizon, bptt)
        last_obs = env_mod.observe(final)

        # --- GAE on the planes (the last value in float32 under both dtypes)
        mark("gae")
        with torch.no_grad():
            last_value = lstm_value(last_obs, last_carry, theta, *arch)
        advret = normalized_advret(planes, last_value, cfg, mesh)

        # --- epochs x minibatches through K7 and K4 ------------------------
        mark("update")
        ls = lstm_weights(theta, *arch)[6]
        st_all = torch.empty(n_steps, N_UPSTATS, device=dev)
        ls_all = torch.empty(n_steps, 4, device=dev)

        def sgd_step(i, perm_mb):
            # the entropy at the pre-update log_std (state-independent)
            ls_all[i] = ls
            grads, st = lstm_update_cuda(planes, advret, snap, perm_mb, theta,
                                         arch, co, rbl, bptt, cfg.ent_coef,
                                         compute_dtype)
            st_all[i] = st
            all_mean(mesh, grads)
            fused_adam_cuda(theta, grads, mu, nu, count, ac, sched, sizes)

        run_epoch_scans(sgd_step, perms, cfg, mb_rb)
        mark("metrics")
        losses, auxes = losses_fn(st_all, entropies(ls_all))
        metrics = trainer_metrics(stats, losses, auxes, cfg, cfg.num_envs,
                                  mesh)
        runner2 = RecurrentRunnerState(
            params=model, opt_state=(count, mu, nu), env_state=final,
            last_obs=last_obs, generator=runner.generator,
            update_idx=runner.update_idx + 1, carry=last_carry,
            noise_generator=runner.noise_generator)
        mark("end")
        return runner2, metrics

    return train_step
