"""Megakernel PPO: the rollout and update phases in hand-written kernels.

Counterpart of `drone_tpu/ppo_pallas.py` with the fused optimizer:

  rollout   - K2 (ops/cuda_acting_traj.py) streams (obs, action, logp,
              value, reward, done) planes, (T, 21, N), policy and env fused
              per lane, exploration noise from the lanes' counter streams;
  GAE       - a reverse loop over the time-major reward/value/done planes;
  update    - K3 (ops/cuda_update.py) runs each minibatch's forward and
              hand-written backward; a minibatch is a slice of a row-block
              permutation, so shuffling gathers nothing;
  optimizer - K4: clip_by_global_norm + adam over the flat parameters in
              one launch, the learning rate's anneal taken from the step
              count on the device.

The trajectory planes the rollout writes are the buffer the update reads.
On CPU tensors every kernel runs its plain PyTorch version.

Semantics kept from the reference (ppo_pallas.py:26-33): exploration noise
comes from the env's counter streams, not from the permutation generator;
minibatches are shuffled at row-block granularity (`pick_row_block`: 1,024
lanes when a minibatch has 8 or more rows of 128); the optimizer state is
the fused (count, mu, nu) in `_kernel_tensors` order; `compute_dtype`
"bfloat16" runs the bf16 operand arms of K2 and K3 and takes GAE's last
value with bf16 operands too (ppo_pallas.py:366-405). The one deliberate
change: the permutations come from `torch.randperm` with the runner's CPU
`torch.Generator`, where the reference splits a JAX key.

The update runs in place: K4 writes the new parameters, moments and count
into the runner's buffers, and the module's parameters are views of them.
Nothing in an update waits for the host: the permutations go to the device
once per update, and metrics stay on the device until the caller reads
them.
"""

from __future__ import annotations

import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.models.mlp import kernel_order, tensor_sizes
from drone_tpu_torch.ops.cuda_acting_traj import (
    HALF_LOG_2PI,
    TP_DONE,
    TP_REW,
    TP_VAL,
    tower_forward,
    tower_weights,
    traj_rollout_cuda,
)
from drone_tpu_torch.ops.cuda_update import (
    ST_CF,
    ST_KL,
    ST_PG,
    ST_VL,
    N_UPSTATS,
    AdamConsts,
    LrSchedule,
    UpdateConsts,
    fused_adam_cuda,
    ppo_update_cuda,
)
from drone_tpu_torch.parallel.mesh import all_mean, all_sum
from drone_tpu_torch.ppo import (  # noqa: F401 (METRIC_KEYS re-exported)
    METRIC_KEYS,
    PPOConfig,
    RunnerState,
    compute_gae,
    make_optimizer,
    normalize_advantages,
)


def kernel_tensors(model):
    """The flat parameter buffer of a flattened ActorCritic (kernel order)
    and its hidden widths."""
    if getattr(model, "flat", None) is None:
        raise ValueError("the model's parameters are not flat: call "
                         "ActorCritic.flatten_() (init_runner does)")
    return model.flat, model.hidden


def pick_row_block(mb_rows: int) -> int:
    """Rows of 128 lanes per shuffled block: the largest power-of-two
    divisor of the minibatch's row count that is <= 8."""
    for k in (8, 4, 2):
        if mb_rows % k == 0:
            return k
    return 1


def plan_minibatch_geometry(cfg: PPOConfig, local_envs: int):
    """Lane-row / row-block tiling. Returns (rows, mb_rows, rbu, n_rb,
    mb_rb, co). Raises when the lanes do not split into minibatches of whole
    rows."""
    if local_envs % 128:
        raise ValueError(f"the megakernel trainer needs num_envs % 128 == 0, "
                         f"got {local_envs}")
    rows = local_envs // 128
    if rows % cfg.num_minibatches:
        raise ValueError(f"lane rows ({rows} = {local_envs}/128) must divide "
                         f"into {cfg.num_minibatches} minibatches")
    mb_rows = rows // cfg.num_minibatches
    m_samples = mb_rows * 128 * cfg.horizon
    co = UpdateConsts(clip_eps=cfg.clip_eps, vf_clip=cfg.vf_clip,
                      vf_coef=cfg.vf_coef, inv_m=1.0 / m_samples)
    rbu = pick_row_block(mb_rows)
    return rows, mb_rows, rbu, rows // rbu, mb_rows // rbu, co


def make_fused_lr(cfg: PPOConfig) -> LrSchedule:
    """lr schedule of the fused optimizer: ppo.make_optimizer's linear
    anneal over all optimizer steps of the run."""
    return make_optimizer(cfg)[1]


def normalized_advret(planes, last_value, cfg: PPOConfig, mesh=None):
    """GAE on the time-major planes + advantage normalization over the
    batch (every rank's with a mesh) -> stacked (2, T, N) [adv, ret]. The
    variance is the population variance, as jnp.var."""
    adv, ret = compute_gae(planes[:, TP_REW], planes[:, TP_VAL],
                           planes[:, TP_DONE], last_value, cfg.gamma,
                           cfg.gae_lambda)
    return torch.stack([normalize_advantages(adv, mesh), ret])


def make_losses(cfg: PPOConfig, co: UpdateConsts):
    """Loss/aux bookkeeping from the update kernel's stat sums: st (steps,
    8), ent (steps,) -> (loss (steps,), aux dict of (steps,))."""

    def _losses(st, ent):
        pg_loss = st[:, ST_PG] * co.inv_m
        v_loss = 0.5 * st[:, ST_VL] * co.inv_m
        loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
        aux = dict(pg_loss=pg_loss, v_loss=v_loss, entropy=ent,
                   approx_kl=st[:, ST_KL] * co.inv_m,
                   clipfrac=st[:, ST_CF] * co.inv_m)
        return loss, aux

    return _losses


def run_epoch_scans(step_fn, perms, cfg: PPOConfig, mb_rb: int):
    """epochs x minibatches: step_fn(i, perm_mb) for minibatch i, the
    mb_rb-long slices of each epoch's row-block permutation in order."""
    i = 0
    for e in range(cfg.epochs):
        for mb in range(cfg.num_minibatches):
            step_fn(i, perms[e, mb * mb_rb:(mb + 1) * mb_rb])
            i += 1


def trainer_metrics(stats, losses, auxes, cfg: PPOConfig, local_envs: int,
                    mesh=None):
    """The metrics of one update, on the device (keys match the
    reference's). With a mesh the episode statistics are summed over the
    ranks and the loss terms averaged (ppo_pallas.py:298-320)."""
    sums = torch.stack([stats[k] for k in ("episodes", "reward_sum",
                                           "ep_return_sum", "ep_length_sum")])
    means = torch.stack([torch.mean(losses),
                         *(torch.mean(v) for v in auxes.values())])
    world = 1
    if mesh is not None:
        all_sum(mesh, sums)
        all_mean(mesh, means)
        world = mesh.world
    n_done, reward_sum, ep_return_sum, ep_length_sum = sums
    # a tensor divisor: on CUDA, torch divides by a Python scalar through
    # its reciprocal. torch.full is a fill on the device; torch.tensor would
    # copy from the host and wait for the update's kernels.
    denom = torch.full((), float(cfg.horizon * local_envs * world),
                       device=n_done.device)
    one = torch.ones((), device=n_done.device)
    return dict(
        loss=means[0],
        reward_mean=reward_sum / denom,
        episodes=n_done,
        ep_return_mean=ep_return_sum / torch.maximum(n_done, one),
        ep_length_mean=ep_length_sum / torch.maximum(n_done, one),
        **{k: means[1 + i] for i, k in enumerate(auxes)},
    )


def draw_permutations(generator: torch.Generator, epochs: int, n_rb: int):
    """(epochs, n_rb) row-block permutations from the CPU generator."""
    return torch.stack([torch.randperm(n_rb, generator=generator)
                        for _ in range(epochs)])


def update_permutations(runner, permutations, cfg: PPOConfig, n_rb: int,
                        device):
    """One update's (epochs, n_rb) int32 row-block permutations on
    `device`: permutations(runner) when given, else drawn from the runner's
    CPU generator."""
    perms = (permutations(runner) if permutations is not None
             else draw_permutations(runner.generator, cfg.epochs, n_rb))
    perms = torch.as_tensor(perms, dtype=torch.int32)
    if device.type == "cuda":
        # from pinned memory the copy queues behind the previous update
        # instead of waiting for it
        perms = perms.pin_memory()
    return perms.to(device, non_blocking=True)


def entropies(ls_all):
    """The Gaussian policy's entropy at each SGD step's log_std, (steps,)
    from (steps, 4)."""
    return torch.sum(ls_all + 0.5 * (1.0 + 2.0 * HALF_LOG_2PI), dim=1)


def make_train_step(env, cfg: PPOConfig, permutations=None, on_phase=None,
                    compute_dtype: str = "float32", mesh=None):
    """Build the megakernel train step: RunnerState -> (RunnerState,
    metrics), with the env's params and device. compute_dtype: "float32",
    or "bfloat16" for the bf16 operand arms of K2 and K3 (their products'
    operands rounded to bfloat16, sums in float32).

    permutations: optional callable runner -> (epochs, n_rb) row-block
    permutations, to replay another trainer's shuffling (the tests feed in
    the reference's); by default they come from runner.generator.
    on_phase: optional callable(name), called on the host as the step
    starts to queue each phase ("rollout", "gae", "update", "metrics") and
    once more ("end") before it returns. A caller that records a CUDA event
    in it gets each phase's time on the device (chip_smoke.py does).
    mesh: None, or the parallel.mesh.Mesh whose ranks each train this step
    on their cfg.num_envs lanes: advantages normalized over every rank's,
    each SGD step's gradient averaged before K4, the metrics reduced
    (parallel.train_sharded)."""
    _, _, rbu, n_rb, mb_rb, co = plan_minibatch_geometry(cfg, cfg.num_envs)
    rbl = rbu * 128
    ac = AdamConsts(clip_norm=cfg.max_grad_norm)
    sched = make_fused_lr(cfg)
    losses_fn = make_losses(cfg, co)
    n_steps = cfg.epochs * cfg.num_minibatches
    mark = on_phase or (lambda name: None)

    def train_step(runner: RunnerState):
        mark("rollout")
        theta, hidden = kernel_tensors(runner.params)
        sizes = tensor_sizes(kernel_order(hidden))
        count, mu, nu = runner.opt_state
        dev = theta.device
        if runner.env_state.n != cfg.num_envs:
            raise ValueError(f"the runner has {runner.env_state.n} lanes, "
                             f"the config {cfg.num_envs}")
        perms = update_permutations(runner, permutations, cfg, n_rb, dev)

        # --- rollout: trajectory planes (T, 21, N) ------------------------
        final, planes, stats = traj_rollout_cuda(
            runner.env_state, theta, hidden, env.params, env.statics,
            cfg.horizon, compute_dtype=compute_dtype)
        last_obs = env_mod.observe(final)

        # --- GAE on the planes ---------------------------------------------
        mark("gae")
        _, critic, ls = tower_weights(theta, hidden)
        with torch.no_grad():
            # the rollout's value function: bf16 operands under bfloat16
            last_value = tower_forward(last_obs, critic, compute_dtype)[:, 0]
        advret = normalized_advret(planes, last_value, cfg, mesh)

        # --- epochs x minibatches through K3 and K4 ------------------------
        mark("update")
        st_all = torch.empty(n_steps, N_UPSTATS, device=dev)
        ls_all = torch.empty(n_steps, 4, device=dev)

        def sgd_step(i, perm_mb):
            # the entropy at the pre-update log_std (state-independent)
            ls_all[i] = ls
            grads, st = ppo_update_cuda(planes, advret, perm_mb, theta,
                                        hidden, co, rbl, cfg.ent_coef,
                                        compute_dtype)
            st_all[i] = st
            all_mean(mesh, grads)
            fused_adam_cuda(theta, grads, mu, nu, count, ac, sched, sizes)

        run_epoch_scans(sgd_step, perms, cfg, mb_rb)
        mark("metrics")
        ent = entropies(ls_all)
        losses, auxes = losses_fn(st_all, ent)
        metrics = trainer_metrics(stats, losses, auxes, cfg, cfg.num_envs,
                                  mesh)
        runner2 = RunnerState(params=runner.params, opt_state=(count, mu, nu),
                              env_state=final, last_obs=last_obs,
                              generator=runner.generator,
                              update_idx=runner.update_idx + 1,
                              noise_generator=runner.noise_generator)
        mark("end")
        return runner2, metrics

    return train_step

