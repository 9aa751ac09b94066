"""Training and evaluation entry points (counterpart of `drone_tpu/train.py`).

`train` is the outer loop around a train step: config -> env -> policy ->
loop { rollout + update on the device } with metrics, periodic checkpoints
and exact resume. The host reads scalar metrics back only every
log_interval updates. `build` picks the trainer as the reference does
(`trainer_kind`, asking the kernels' own envelope checks): the megakernel
trainers (`ppo_cuda.make_train_step` for run.policy=mlp,
`ppo_cnn_cuda.make_cnn_train_step` for cnn,
`ppo_rnn_cuda.make_rnn_train_step` for lstm and cnn_lstm) where their
kernels take the run; for the recurrent families the hybrid tier (K6's
rollout, an autograd update, `ppo_rnn.make_recurrent_train_step(rollout=
"pallas")`) where K6 takes it and K7 does not; and the scan trainers
(`ppo.make_train_step`, `ppo_rnn.make_recurrent_train_step`) for
run.rollout=scan, for run.policy=cnn_overlap and for every run no kernel
tier takes. Every trainer keeps one optimizer state, so a checkpoint of any
of them resumes under any other. run.compute_dtype=bfloat16 runs the bf16
operand arms of the megakernel trainers' kernels (K2 and K3, K9 and K10,
and K7 for both recurrent families, whose rollout K6 and last value stay
float32) and trains `ActorCritic(dtype=bfloat16)` on the MLP's scan tier,
as the reference does; the recurrent hybrid and scan tiers train float32,
as the reference's do. run.profile_dir traces updates start + 2 to
start + 4. With run.mesh set and a process group of more than one rank up
(torchrun, `parallel.multihost.initialize_multihost`) whose world size
divides train.num_envs, `build` shards the run: each rank trains its lanes
through `parallel.make_sharded_train_step`, the trainer picked for its
local lane count; only rank 0 logs and writes checkpoints, which hold the
global runner.
`evaluate` restores a policy and rolls it out through the acting kernel
(K5 for a float32 MLP, K8 for both recurrent families, K11 for a float32
CNN) when the kernel's own envelope check takes the policy, and through
the module otherwise, as the reference serves every policy it builds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from pathlib import Path

import torch
from torch import nn

from drone_tpu_torch import ppo_rnn
from drone_tpu_torch.env import DroneEnv
from drone_tpu_torch.models import (
    ActorCritic,
    CNNLSTMActorCritic,
    LSTMActorCritic,
    PatchCNNActorCritic,
    PixelActorCritic,
)
from drone_tpu_torch.models.cnn import check_cnn_checkpoint_layout
from drone_tpu_torch.ops import (
    act_rollout_cuda,
    cnn_act_rollout_cuda,
    cuda_acting,
    cuda_acting_cnn,
    cuda_acting_traj,
    cuda_update,
    lstm_act_rollout_cuda,
)
from drone_tpu_torch.ops.cuda_acting_lstm import check_act_envelope
from drone_tpu_torch.ops.cuda_update_lstm import check_envelope
from drone_tpu_torch.parallel import make_sharded_train_step
from drone_tpu_torch.parallel.mesh import (
    Mesh,
    gather_runner,
    make_mesh,
    world_size,
)
from drone_tpu_torch.parallel.multihost import global_init_runner
from drone_tpu_torch.ppo import init_runner
from drone_tpu_torch.ppo_rnn import init_recurrent_runner, rollout_recurrent
from drone_tpu_torch.rollout import rollout_policy
from drone_tpu_torch.types import resolve_device
from drone_tpu_torch.utils.checkpoint import Checkpointer
from drone_tpu_torch.utils.config import Config
from drone_tpu_torch.utils.metrics import (
    MetricsLogger,
    RichDashboard,
    dashboard_line,
)
from drone_tpu_torch.utils.profiling import trace

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
_RECURRENT = ("lstm", "cnn_lstm")
# trainer_kind -> make_sharded_train_step's trainer, as the reference names
# its tiers
_TRAINERS = {"megakernel": "pallas", "hybrid": "pallas_rollout",
             "scan": "scan"}


def build_env_and_model(cfg: Config, device="cuda"):
    """Config -> (env, model) on `device`: the one policy-model switch."""
    device = resolve_device(device)
    statics, params = cfg.env.build()
    env = DroneEnv(task=statics.task, integrator=statics.integrator,
                   params=params, device=device)
    # initialised on the CPU from the run's seed (the card and the CPU start
    # from the same weights), then moved
    generator = torch.Generator().manual_seed(cfg.run.seed)
    if cfg.run.policy == "lstm":
        # the encoder is run.hidden[:1], as the reference builds it
        model = LSTMActorCritic(hidden=cfg.run.lstm_hidden,
                                encoder=tuple(cfg.run.hidden)[:1],
                                generator=generator)
    elif cfg.run.policy == "cnn_lstm":
        # the default patch-CNN tower into the LSTM, as the reference builds
        # it
        model = CNNLSTMActorCritic(hidden=cfg.run.lstm_hidden,
                                   generator=generator)
    elif cfg.run.policy == "cnn":
        # the reference always builds the default PatchCNNActorCritic
        model = PatchCNNActorCritic(generator=generator)
    elif cfg.run.policy == "cnn_overlap":
        # the overlapping-conv pixel CNN: no kernel takes its windows, so it
        # trains on the scan trainer only
        model = PixelActorCritic(generator=generator)
    elif cfg.run.policy == "mlp":
        model = ActorCritic(hidden=tuple(cfg.run.hidden),
                            dtype=_DTYPES[cfg.run.compute_dtype],
                            generator=generator)
    else:
        raise ValueError(f"run.policy must be 'mlp', 'cnn', 'cnn_overlap', "
                         f"'lstm' or 'cnn_lstm', got {cfg.run.policy!r}")
    return env, model.to(device)


def restore_dir(cfg: Config) -> Path:
    """Where eval restores from: run.resume_from when set, else the run's
    own checkpoint dir."""
    if cfg.run.resume_from:
        return Path(cfg.run.resume_from)
    return Path(cfg.run.checkpoint_dir) / cfg.run.run_name / "checkpoints"


def train_mesh(cfg: Config, device="cuda") -> Mesh | None:
    """The mesh build() shards a run over: run.mesh set, a process group of
    more than one rank, and train.num_envs dividing by its world size
    (drone_tpu/train.py:105-108); else None."""
    world = world_size()
    if cfg.run.mesh and world > 1 and cfg.train.num_envs % world == 0:
        return make_mesh(device)
    return None


def local_config(cfg: Config, mesh: Mesh | None) -> Config:
    """cfg with train.num_envs the lanes of one rank of `mesh`."""
    if mesh is None:
        return cfg
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_envs=cfg.train.num_envs // mesh.world))


def build(cfg: Config, device="cuda"):
    """Config -> (env, model, runner, step_fn, cfg with train.total_updates
    synced from run.total_updates), the trainer picked by trainer_kind.
    run.compute_dtype reaches the megakernel trainers; the recurrent hybrid
    and scan tiers take none (float32), as the reference's. Sharded over
    train_mesh(cfg) when there is one: the runner holds the rank's lanes,
    and trainer_kind sees their count. The step carries its choices:
    step.mesh (None when unsharded) and step.kind (trainer_kind's)."""
    # run.total_updates is the run's length; the lr anneal spans it
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, total_updates=cfg.run.total_updates))
    _check_options(cfg)
    env, model = build_env_and_model(cfg, device)
    mesh = train_mesh(cfg, env.device)
    kind = trainer_kind(local_config(cfg, mesh), model)
    recurrent = cfg.run.policy in _RECURRENT
    init = init_recurrent_runner if recurrent else init_runner

    def init_fn(first_lane, num_envs):
        return init(model, env, dataclasses.replace(cfg.train,
                                                    num_envs=num_envs),
                    seed=cfg.run.seed, first_lane=first_lane)

    if mesh is None:
        runner = init_fn(0, cfg.train.num_envs)
    else:
        runner = global_init_runner(init_fn, mesh, cfg.train.num_envs)
    step = make_sharded_train_step(
        runner.params, env, cfg.train, mesh, trainer=_TRAINERS[kind],
        recurrent=recurrent, policy=cfg.run.policy,
        compute_dtype=cfg.run.compute_dtype)
    step.mesh, step.kind = mesh, kind
    return env, runner.params, runner, step, cfg


def trainer_kind(cfg: Config, model) -> str:
    """The trainer build() runs: "megakernel", "hybrid" (the recurrent
    families' K6 rollout with an autograd update) or "scan", as the
    reference picks it (drone_tpu/train.py build) with the port's own
    envelope checks. run.rollout=scan always takes the scan trainer;
    run.rollout=pallas raises ValueError for a run no kernel tier takes."""
    tc = cfg.train
    rows = tc.num_envs % (128 * tc.num_minibatches) == 0
    split = (None if rows else
             f"num_envs={tc.num_envs} does not split into "
             f"{tc.num_minibatches} minibatches of 128-lane rows (num_envs "
             f"divisible by 128*num_minibatches)")
    if cfg.run.policy == "cnn_overlap":
        if cfg.run.rollout == "pallas":
            raise ValueError(
                "run.rollout='pallas' has no megakernel for "
                "run.policy='cnn_overlap' (its conv windows overlap); it "
                "trains on the scan trainer (run.rollout=scan or auto)")
        return "scan"
    if cfg.run.policy in _RECURRENT:
        ppo_rnn.bptt_of(tc)  # the horizon splits into segments
        k7 = _outside(check_envelope, model.hidden, model.encoder,
                      cfg.run.compute_dtype) or split
        k6 = _outside(check_act_envelope, model.hidden, model.encoder) or (
            None if tc.num_envs % tc.num_minibatches == 0 else
            f"num_envs={tc.num_envs} does not split into "
            f"{tc.num_minibatches} minibatches")
        if cfg.run.rollout == "scan":
            return "scan"
        if not k7:
            return "megakernel"
        if not k6:
            return "hybrid"
        if cfg.run.rollout == "pallas":
            raise ValueError(f"run.rollout='pallas': neither the recurrent "
                             f"megakernel trainer ({k7}) nor the hybrid tier "
                             f"({k6}) takes this run")
        return "scan"
    if cfg.run.policy == "mlp":
        outside = (_outside(cuda_acting_traj.traj_layout, model.hidden)
                   or _outside(cuda_update.update_layout, model.hidden))
    else:
        outside = _outside(cuda_acting_cnn.check_envelope, model.arch)
    outside = outside or split
    if cfg.run.rollout == "scan":
        return "scan"
    if not outside:
        return "megakernel"
    if cfg.run.rollout == "pallas":
        raise ValueError(f"run.rollout='pallas': the megakernel trainer "
                         f"cannot take this run: {outside}")
    return "scan"


def _check_cnn_checkpoint_layout(cfg: Config, raw_params):
    """run.policy='cnn' builds PatchCNNActorCritic: the parameters of the
    overlapping-conv PixelActorCritic (a `cnn` submodule) fail with the
    rename, not with a state-dict mismatch."""
    if cfg.run.policy == "cnn":
        check_cnn_checkpoint_layout(raw_params)


def _check_options(cfg: Config):
    """The run options every trainer reads."""
    if cfg.run.rollout not in ("auto", "pallas", "scan"):
        raise ValueError(f"run.rollout must be 'scan', 'pallas' or 'auto', "
                         f"got {cfg.run.rollout!r}")
    if cfg.run.compute_dtype not in _DTYPES:
        raise ValueError(f"run.compute_dtype must be one of {list(_DTYPES)}, "
                         f"got {cfg.run.compute_dtype!r}")


def _outside(check, *args) -> str | None:
    """The reason a kernel's own envelope check gives for refusing args, or
    None when the kernel takes them."""
    try:
        check(*args)
    except ValueError as e:
        return str(e)
    return None


def train(cfg: Config, on_update=None, device="cuda"):
    """Run cfg.run.total_updates updates on `device`. Returns (runner, the
    last logged metrics record). In a sharded run (train_mesh) every rank
    trains its lanes; rank 0 alone logs, calls on_update and writes the
    checkpoints (the global runner, gathered from every rank), and the
    other ranks return None for the record."""
    env, model, runner, step, cfg = build(cfg, device)
    mesh = step.mesh
    lead = mesh is None or mesh.rank == 0

    run_dir = Path(cfg.run.checkpoint_dir) / cfg.run.run_name
    ckpt = Checkpointer(run_dir / "checkpoints")
    # a fresh run must not write into a directory holding another run's
    # checkpoints (eval would serve a mix); resuming this run's own
    # directory is the one legitimate overlap
    resume_self = (bool(cfg.run.resume_from)
                   and Path(cfg.run.resume_from).resolve() == ckpt.dir)
    if not resume_self and ckpt.dir.is_dir() and any(ckpt.dir.iterdir()):
        raise RuntimeError(
            f"checkpoint directory {ckpt.dir} already contains a previous "
            f"run's checkpoints. Pick a fresh run.run_name, remove the "
            f"directory, or continue that run with "
            f"run.resume_from={ckpt.dir}")
    start_update = 0
    if cfg.run.resume_from:
        resume = Checkpointer(cfg.run.resume_from)
        _check_cnn_checkpoint_layout(cfg, resume.restore_raw()[0]["params"])
        runner, start_update = resume.restore(runner, mesh=mesh)
        if lead:
            print(f"resumed from {cfg.run.resume_from} at update "
                  f"{start_update}")

    def save(u):
        if mesh is None:
            ckpt.save(u, runner)
            return
        full, rank_generators = gather_runner(mesh, runner)
        if lead:
            ckpt.save(u, full, rank_generators)

    logger = rich_dash = None
    if lead:
        metrics_path = cfg.run.metrics_path or (run_dir / "metrics.jsonl")
        logger = MetricsLogger(
            metrics_path,
            tb_dir=(run_dir / "tb") if cfg.run.tensorboard else None)
        rich_dash = (RichDashboard(cfg.run.total_updates)
                     if cfg.run.dashboard == "rich" else None)

    steps_per_update = cfg.train.horizon * cfg.train.num_envs
    last = None
    t_last = time.time()
    u_last = start_update
    profiling = contextlib.ExitStack()
    try:
        for u in range(start_update, cfg.run.total_updates):
            if lead and cfg.run.profile_dir and u == start_update + 2:
                # a trace of warmed-up updates (the reference's XProf trace)
                profiling.enter_context(
                    trace(str(Path(cfg.run.profile_dir) / "trace")))
            runner, m = step(runner)
            if lead and cfg.run.profile_dir and u == start_update + 4:
                float(m["loss"])  # the card's queue drains into the trace
                profiling.close()
            if ((u + 1) % cfg.run.log_interval == 0
                    or u == cfg.run.total_updates - 1):
                # reading the loss waits for the device, so the clock below
                # covers the work of the updates since the last log
                loss_val = float(m["loss"])
                if math.isnan(loss_val):
                    raise RuntimeError(
                        f"training diverged: loss is NaN at update {u + 1} "
                        f"(last checkpoint in {run_dir}/checkpoints; resume "
                        f"with a lower train.lr or tighter "
                        f"train.max_grad_norm)")
                now = time.time()
                sps = steps_per_update * (u + 1 - u_last) / (now - t_last)
                t_last = now
                u_last = u + 1
                if lead:
                    last = _log(logger, rich_dash, on_update, u + 1, cfg,
                                steps_per_update, m, sps)
            if (u + 1) % cfg.run.checkpoint_interval == 0:
                save(u + 1)
        if cfg.run.save_final:
            save(cfg.run.total_updates)
    finally:
        profiling.close()
        if logger is not None:
            logger.close()
        if rich_dash is not None:
            rich_dash.close()
    return runner, last


def _log(logger, rich_dash, on_update, u, cfg, steps_per_update, m, sps):
    """Log update u's metrics: the record, on the dashboard and to
    on_update. Returns the record."""
    rec = logger.log(u * steps_per_update, m, sps=sps)
    if rich_dash is not None:
        rich_dash.update(u, rec)
    else:
        print(dashboard_line(u, cfg.run.total_updates, rec), flush=True)
    if on_update is not None:
        on_update(u, rec)
    return rec


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
    """Roll out the restored (or given: `runner.params`, a state dict or a
    module) policy for horizon + 1 steps on `episodes` lanes and report
    episode stats. A deterministic float32 MLP policy goes through the
    acting kernel K5, a deterministic LSTM or CNN-LSTM policy through K8, a
    deterministic CNN policy through K11 (their plain versions on the CPU),
    each when its kernel's envelope check takes the policy; the rest
    through the module."""
    env, model = build_env_and_model(cfg, device)
    given = None
    if runner is None:
        raw, _ = Checkpointer(restore_dir(cfg)).restore_raw()
        params = raw["params"]
    else:
        params = runner.params
    if isinstance(params, nn.Module):
        given, params = params, params.state_dict()
    _check_cnn_checkpoint_layout(cfg, params)
    if given is not None and next(given.parameters()).device == env.device:
        # the module as given: also one no config builds (an LSTM over an
        # encoder module)
        model = given
    else:
        model.load_state_dict(params)
    model.eval()

    n = episodes
    state = env.init_batch(cfg.run.seed + 1, n)
    horizon = int(env.params.horizon) + 1

    if cfg.run.policy in _RECURRENT:
        carry = model.initial_carry(n, env.device)
        if deterministic and not _outside(check_act_envelope, model.hidden,
                                          model.encoder):
            _, _, stats = lstm_act_rollout_cuda(
                state, model.flat_params(), (model.hidden, model.encoder),
                carry, env.params, env.statics, horizon)
            return _episode_stats(stats)
        _, _, out = rollout_recurrent(
            model, env, state, carry, horizon,
            generator=torch.Generator(device=env.device).manual_seed(0),
            deterministic=deterministic)
        return _stats_of(out)

    # the kernels serve in float32: a bf16-trained policy is a slightly
    # different function, so it goes through the module, the MLP's with
    # its dtype (the CNN's module computes in float32, as the reference's)
    if (cfg.run.policy == "cnn_overlap"
            or (cfg.run.policy == "cnn" and cfg.run.compute_dtype != "float32")):
        return _module_rollout(model, env, state, horizon, deterministic)
    if cfg.run.policy == "cnn" and deterministic:
        _, stats = cnn_act_rollout_cuda(state, model.flat_params(),
                                        model.arch, env.params, env.statics,
                                        horizon)
        return _episode_stats(stats)

    if (deterministic and cfg.run.compute_dtype == "float32"
            and not _outside(cuda_acting.check_envelope, model.hidden)):
        _, stats = act_rollout_cuda(state, model, env.params, env.statics,
                                    horizon)
        return _episode_stats(stats)
    return _module_rollout(model, env, state, horizon, deterministic)


def _module_rollout(model, env, state, horizon, deterministic) -> dict:
    """Episode statistics of a feed-forward policy rolled out through the
    module."""
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
    return _stats_of(out)


def _stats_of(out) -> dict:
    """Episode statistics of a stacked StepOut."""
    done = (out.terminated | out.truncated).cpu().numpy()
    rets = out.ep_return.cpu().numpy()[done]
    lens = out.ep_length.cpu().numpy()[done]
    return {
        "episodes": int(done.sum()),
        "ep_return_mean": float(rets.mean()) if rets.size else float("nan"),
        "ep_return_std": float(rets.std()) if rets.size else float("nan"),
        "ep_length_mean": float(lens.mean()) if lens.size else float("nan"),
    }
