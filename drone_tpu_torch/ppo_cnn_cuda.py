"""CNN megakernel PPO: the patch-CNN rollout and update in hand-written
kernels.

Counterpart of `drone_tpu/ppo_cnn_pallas.py` with the fused optimizer
(`make_pallas_cnn_train_step(..., fused_optimizer=True)`):

  rollout   - K9 (ops/cuda_acting_cnn.py) streams the (T, 21, N) planes of
              the MLP trainer: the pixels are re-rendered in the kernel from
              the observation and never stored;
  GAE       - ppo_cuda's, with the bootstrap value of the last obs from the
              module's own forward on the device in float32, and under
              bfloat16 from the plane-space forward with bf16 operands
              (`cuda_acting_cnn.cnn_forward`, the rollout's value function;
              the reference takes it through XLA, outside any kernel);
  update    - K10 (ops/cuda_update_cnn.py) per minibatch: row blocks of
              whole lanes, the conv forward and hand-written backward with
              the patches re-rendered from the stored obs planes;
  optimizer - K4 (ops/cuda_update.py) over the CNN's 11 tensors.

The trainer scaffolding (minibatch geometry, advantage normalization, the
losses from the stat sums, the epoch loop, the metrics, the permutations)
is ppo_cuda's. As there, the one deliberate change from the reference: the
permutations come from the runner's CPU `torch.Generator`. The update runs
in place on the runner's buffers and waits for the host nowhere.
`compute_dtype` "bfloat16" runs the bf16 operand arms of K9 and K10
(ppo_cnn_pallas.py:129-189).
"""

from __future__ import annotations

import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.models.cnn import CnnGeom, cnn_all_weights
from drone_tpu_torch.models.mlp import tensor_sizes
from drone_tpu_torch.ops.cuda_acting_cnn import (
    cnn_forward,
    traj_cnn_rollout_cuda,
)
from drone_tpu_torch.ops.cuda_update import (
    N_UPSTATS,
    AdamConsts,
    fused_adam_cuda,
)
from drone_tpu_torch.ops.cuda_update_cnn import ppo_cnn_update_cuda
from drone_tpu_torch.parallel.mesh import all_mean
from drone_tpu_torch.pixels import patch_grid
from drone_tpu_torch.ppo import PPOConfig, RunnerState
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
from drone_tpu_torch.utils.profiling import phases


def cnn_geom(model) -> CnnGeom:
    """PatchCNNActorCritic -> its static patch geometry."""
    return model.arch.geom


def cnn_kernel_tensors(model):
    """The flat parameter buffer of a flattened PatchCNNActorCritic (the
    reference's cnn_kernel_tensors order, one buffer) and its architecture.
    """
    if getattr(model, "flat", None) is None:
        raise ValueError("the model's parameters are not flat: call "
                         "PatchCNNActorCritic.flatten_() (init_runner does)")
    return model.flat, model.arch


def make_cnn_train_step(env, cfg: PPOConfig, permutations=None,
                        on_phase=None, compute_dtype: str = "float32",
                        mesh=None):
    """Build the CNN megakernel train step: RunnerState (params a
    PatchCNNActorCritic) -> (RunnerState, metrics), with the env's params
    and device. permutations, on_phase, compute_dtype and mesh as in
    ppo_cuda.make_train_step."""
    _, _, rbu, n_rb, mb_rb, co = plan_minibatch_geometry(cfg, cfg.num_envs)
    rbl = rbu * 128
    ac = AdamConsts(clip_norm=cfg.max_grad_norm)
    sched = make_fused_lr(cfg)
    losses_fn = make_losses(cfg, co)
    n_steps = cfg.epochs * cfg.num_minibatches
    mark = phases(on_phase)

    def train_step(runner: RunnerState):
        mark("rollout")
        model = runner.params
        theta, arch = cnn_kernel_tensors(model)
        sizes = tensor_sizes(model.kernel_order())
        count, mu, nu = runner.opt_state
        dev = theta.device
        if runner.env_state.n != cfg.num_envs:
            raise ValueError(f"the runner has {runner.env_state.n} lanes, "
                             f"the config {cfg.num_envs}")
        perms = update_permutations(runner, permutations, cfg, n_rb, dev)

        # --- rollout: trajectory planes (T, 21, N) ------------------------
        final, planes, stats = traj_cnn_rollout_cuda(
            runner.env_state, theta, arch, env.params, env.statics,
            cfg.horizon, compute_dtype=compute_dtype)
        last_obs = env_mod.observe(final)

        # --- GAE on the planes ---------------------------------------------
        mark("gae")
        with torch.no_grad():
            if compute_dtype == "float32":
                last_value = model(last_obs)[2]
            else:
                # the rollout's value function, bf16 operands
                last_value = cnn_forward(
                    last_obs, cnn_all_weights(theta, arch),
                    *patch_grid(arch.res, arch.p0, dev), arch.geom,
                    compute_dtype=compute_dtype)[1]
        advret = normalized_advret(planes, last_value, cfg, mesh)

        # --- epochs x minibatches through K10 and K4 -----------------------
        mark("update")
        ls = cnn_all_weights(theta, arch)[8]
        st_all = torch.empty(n_steps, N_UPSTATS, device=dev)
        ls_all = torch.empty(n_steps, 4, device=dev)

        def sgd_step(i, perm_mb):
            # the entropy at the pre-update log_std (state-independent)
            ls_all[i] = ls
            grads, st = ppo_cnn_update_cuda(planes, advret, perm_mb, theta,
                                            arch, co, rbl, cfg.ent_coef,
                                            compute_dtype)
            st_all[i] = st
            all_mean(mesh, grads)
            fused_adam_cuda(theta, grads, mu, nu, count, ac, sched, sizes)

        run_epoch_scans(sgd_step, perms, cfg, mb_rb)
        mark("metrics")
        losses, auxes = losses_fn(st_all, entropies(ls_all))
        metrics = trainer_metrics(stats, losses, auxes, cfg, cfg.num_envs,
                                  mesh)
        runner2 = RunnerState(params=model, opt_state=(count, mu, nu),
                              env_state=final, last_obs=last_obs,
                              generator=runner.generator,
                              update_idx=runner.update_idx + 1,
                              noise_generator=runner.noise_generator)
        mark("end")
        return runner2, metrics

    return train_step
