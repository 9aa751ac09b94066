"""drone_tpu_torch.parallel and ops.sharded: data-parallel training over
torch.distributed, on the CPU with Gloo.

Two Gloo ranks of N lanes each make one update equal to one undistributed
update of the 2N-lane global batch, in every trainer tier (allclose at
tests/test_sharding.py's rtol 2e-5 / atol 1e-7: the sums only change
order), and the scan tier's two ranks equal drone_tpu's sharded step on
two virtual CPU devices on its own draws; a world of one is the
undistributed update bit for bit, in every tier; two Gloo processes of the
smoke worker report the same loss bit for bit; a rank's lanes are the
unsharded batch's lanes; the sharded K1 and K5 (their plain versions) give
each rank the unsharded run's lanes and the statistics summed over the
ranks; a two-rank `cli train` (torchrun's environment) checkpoints the
global runner, and a two-rank run resumed from its checkpoint is the
uninterrupted run bit for bit. Templates: tests/test_multiprocess.py and
tests/test_sharding.py.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from drone_tpu_torch import ppo, ppo_rnn, train
from drone_tpu_torch.env import DroneEnv
from drone_tpu_torch.models import ActorCritic
from drone_tpu_torch.ops.cuda_acting import act_rollout_cuda
from drone_tpu_torch.ops.cuda_rollout import rollout_cuda
from drone_tpu_torch.ops.sharded import (
    sharded_act_rollout_cuda,
    sharded_rollout_cuda,
)
from drone_tpu_torch.parallel import make_sharded_train_step, runner_sharding
from drone_tpu_torch.parallel.mesh import Mesh, make_mesh, place_runner
from drone_tpu_torch.parallel.multihost import (
    global_init_runner,
    initialize_multihost,
)
from drone_tpu_torch.parallel.scaling import run_scaling
from drone_tpu_torch.utils.checkpoint import Checkpointer
from drone_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 300


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child_env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def _communicate(procs):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, out[-3000:]
    return outs


@pytest.fixture(scope="module")
def world_of_one():
    """A Gloo process group of one rank in this process."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    yield make_mesh("cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("trainer", ["scan", "pallas"])
def test_two_process_sharded_training(trainer):
    """Two Gloo ranks, two sharded updates: the same loss bit for bit (the
    parameters stay replicated through the averaged gradients)."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "drone_tpu_torch.parallel._smoke_worker",
         str(port), "2", str(pid), trainer, "cpu", "gloo"],
        cwd=REPO, env=_child_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs = _communicate(procs)
    lines = [line for o in outs for line in o.splitlines()
             if line.startswith("SMOKE_OK")]
    assert len(lines) == 2, "\n".join(outs)[-2000:]
    assert all("world=2" in line for line in lines), lines
    kind = "megakernel" if trainer == "pallas" else "scan"
    assert all(f"kind={kind} " in line for line in lines), lines
    losses = {line.split("loss=")[1].split(" ")[0] for line in lines}
    kls = {line.split("kl=")[1].split(" ")[0] for line in lines}
    assert len(losses) == 1 and len(kls) == 1, lines


TIERS = {
    "mlp megakernel": ("megakernel", ["train.num_envs=256", "train.horizon=8",
                                      "train.num_minibatches=2",
                                      "run.hidden=16,16"]),
    "mlp scan": ("scan", ["run.rollout=scan", "train.num_envs=32",
                          "train.horizon=4", "train.num_minibatches=2",
                          "run.hidden=16,16", "train.grad_accum=2"]),
    "cnn megakernel": ("megakernel", ["run.policy=cnn", "train.num_envs=256",
                                      "train.horizon=4",
                                      "train.num_minibatches=2",
                                      "train.epochs=1"]),
    "lstm megakernel": ("megakernel", ["run.policy=lstm", "run.lstm_hidden=16",
                                       "run.hidden=16", "train.num_envs=256",
                                       "train.horizon=8",
                                       "train.bptt_horizon=4",
                                       "train.num_minibatches=2"]),
    "lstm hybrid": ("hybrid", ["run.policy=lstm", "run.lstm_hidden=16",
                               "run.hidden=16", "train.num_envs=384",
                               "train.horizon=8", "train.bptt_horizon=4",
                               "train.num_minibatches=2"]),
    "lstm scan": ("scan", ["run.policy=lstm", "run.lstm_hidden=16",
                           "run.hidden=16", "train.num_envs=32",
                           "train.horizon=8", "train.bptt_horizon=4",
                           "train.num_minibatches=2", "run.rollout=scan"]),
}


def _two_updates(overrides, mesh):
    cfg = Config.default().with_overrides(overrides + ["run.total_updates=2"])
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, total_updates=2))
    env, model = train.build_env_and_model(cfg, "cpu")
    kind = train.trainer_kind(cfg, model)
    recurrent = cfg.run.policy in ("lstm", "cnn_lstm")
    init = train.init_recurrent_runner if recurrent else train.init_runner
    runner = init(model, env, cfg.train, seed=0)
    step = make_sharded_train_step(runner.params, env, cfg.train, mesh,
                                   trainer=train._TRAINERS[kind],
                                   recurrent=recurrent, policy=cfg.run.policy)
    for _ in range(2):
        runner, m = step(runner)
    return kind, runner, m


@pytest.mark.parametrize("tier", list(TIERS))
def test_world_of_one_is_the_undistributed_update(tier, world_of_one):
    """Through the collectives of a one-rank group, two updates equal two
    undistributed ones bit for bit: parameters, optimizer state, env state
    and every metric."""
    kind, overrides = TIERS[tier]
    got_kind, a, ma = _two_updates(overrides, None)
    assert got_kind == kind
    _, b, mb = _two_updates(overrides, world_of_one)
    assert torch.equal(a.params.flat, b.params.flat)
    for x, y in zip(a.opt_state, b.opt_state):
        assert torch.equal(x, y)
    assert torch.equal(a.env_state.fstate(), b.env_state.fstate())
    assert set(ma) == set(mb) == set(ppo.METRIC_KEYS)
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


# one update of a global batch in each tier, one epoch of one minibatch:
# the ranks' permutations then only reorder the sums (test_sharding.py:24's
# N-host == 1-host check). The clip is off, so the optimizer's first moment
# is the averaged gradient itself: clipping the global norm to 0.5 would
# map a gradient and twice it to one vector. The lanes split into rows of
# 128 in the megakernel tiers, on one rank and on two; the hybrid tier's do
# not.
EQUIV_TIERS = {
    "mlp megakernel": ("megakernel", ["train.num_envs=512", "train.horizon=8",
                                      "run.hidden=16,16"]),
    "mlp scan": ("scan", ["run.rollout=scan", "train.num_envs=32",
                          "train.horizon=4", "run.hidden=16,16",
                          "train.grad_accum=2"]),
    "cnn megakernel": ("megakernel", ["run.policy=cnn", "train.num_envs=256",
                                      "train.horizon=4"]),
    "lstm megakernel": ("megakernel", ["run.policy=lstm", "run.lstm_hidden=16",
                                       "run.hidden=16", "train.num_envs=256",
                                       "train.horizon=8",
                                       "train.bptt_horizon=4"]),
    "lstm hybrid": ("hybrid", ["run.policy=lstm", "run.lstm_hidden=16",
                               "run.hidden=16", "train.num_envs=320",
                               "train.horizon=8", "train.bptt_horizon=4"]),
    "lstm scan": ("scan", ["run.policy=lstm", "run.lstm_hidden=16",
                           "run.hidden=16", "train.num_envs=32",
                           "train.horizon=8", "train.bptt_horizon=4",
                           "run.rollout=scan"]),
}
ONE_UPDATE = ["train.epochs=1", "train.num_minibatches=1",
              "train.max_grad_norm=1e9", "run.total_updates=1"]


def _global_update(tier):
    """One update of `tier` through train.build, sharded over the process
    group when one of two ranks is up. The scan tiers replay one global
    noise draw, each rank its lanes of it (their noise comes from the
    rank-seeded generators otherwise; the kernels' from the lanes' counter
    streams). Returns the rank's parameters, optimizer state, metrics, env
    state and carry."""
    kind, overrides = EQUIV_TIERS[tier]
    cfg = Config.default().with_overrides(overrides + ONE_UPDATE)
    env, model, runner, step, cfg = train.build(cfg, "cpu")
    assert step.kind == kind, (tier, step.kind)
    recurrent = cfg.run.policy in ("lstm", "cnn_lstm")
    if kind == "scan":
        n = cfg.train.num_envs
        z = torch.from_numpy(np.random.default_rng(7).standard_normal(
            (cfg.train.horizon, n, 4)).astype(np.float32))
        z = z[:, slice(None) if step.mesh is None else step.mesh.lanes(n)]
        local = train.local_config(cfg, step.mesh).train
        make = (ppo_rnn.make_recurrent_train_step if recurrent
                else ppo.make_train_step)
        step = make(runner.params, env, local, noise=lambda r: z,
                    mesh=step.mesh)
    runner, m = step(runner)
    return {"params": runner.params.flat, "opt_state": runner.opt_state,
            "metrics": m, "env_state": runner.env_state.fstate(),
            "carry": getattr(runner, "carry", ())}


def _equivalence_rank(rank, port, out):
    torch.set_num_threads(1)
    initialize_multihost(f"localhost:{port}", 2, rank, "gloo", device="cpu")
    for tier in EQUIV_TIERS:
        torch.save(_global_update(tier), Path(out) / f"{tier}-{rank}.pt")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_rank_updates(tmp_path_factory):
    """Every tier's one update on two Gloo ranks: {tier: [rank 0's, rank
    1's]}."""
    out = tmp_path_factory.mktemp("two_rank_updates")
    torch.multiprocessing.start_processes(
        _equivalence_rank, args=(_free_port(), str(out)), nprocs=2,
        start_method="spawn")
    return {t: [torch.load(out / f"{t}-{r}.pt") for r in range(2)]
            for t in EQUIV_TIERS}


def _allclose(a, b, err, atol=1e-7):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5,
                               atol=atol, err_msg=err)


@pytest.mark.parametrize("tier", list(EQUIV_TIERS))
def test_two_ranks_are_one_update_of_the_global_batch(tier,
                                                      two_rank_updates):
    """Two ranks of N lanes each, one update, against one undistributed
    update of the 2N-lane global batch: parameters, optimizer state and
    metrics allclose on both ranks (a gradient summed but not divided by
    the world, or advantage moments of one rank's lanes, fails here), and
    the ranks' lanes, stepped by the same parameters on the same noise,
    the global run's bit for bit."""
    want = _global_update(tier)
    ranks = two_rank_updates[tier]
    for r, got in enumerate(ranks):
        _allclose(got["params"], want["params"], f"rank {r} params")
        names = ("count", "mu", "nu")
        for name, x, y in zip(names, got["opt_state"], want["opt_state"]):
            _allclose(x, y, f"rank {r} {name}")
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            # a metric is a mean of order-one terms (pg_loss of the first,
            # on-policy step: minus the mean of normalized advantages, 0 up
            # to rounding), so its order changes it by ~1e-7
            _allclose(got["metrics"][k], v, f"rank {r} {k}", atol=1e-6)
    assert torch.equal(ranks[0]["params"], ranks[1]["params"])
    assert torch.equal(torch.cat([g["env_state"] for g in ranks]),
                       want["env_state"])
    for i, c in enumerate(want["carry"]):
        assert torch.equal(torch.cat([g["carry"][i] for g in ranks]), c)


def _reference_rank(rank, port, out):
    """One rank of the scan trainer on the reference's draws for its shard
    (saved by the test): its parameters, optimizer state and metrics."""
    torch.set_num_threads(1)
    mesh = initialize_multihost(f"localhost:{port}", 2, rank, "gloo",
                                device="cpu")
    inputs = torch.load(Path(out) / "inputs.pt")
    cfg = ppo.PPOConfig(**inputs["cfg"])
    env = DroneEnv(device="cpu")
    model = ActorCritic((16, 16))
    model.load_state_dict(inputs["params"])

    def init_fn(first_lane, num_envs):
        return ppo.init_runner(model, env, dataclasses.replace(
            cfg, num_envs=num_envs), seed=1, first_lane=first_lane)

    runner = global_init_runner(init_fn, mesh, cfg.num_envs)
    noise, perms = inputs["draws"][rank]
    step = ppo.make_train_step(
        model, env, dataclasses.replace(cfg, num_envs=cfg.num_envs // 2),
        permutations=lambda r: perms, noise=lambda r: noise, mesh=mesh)
    r2, m = step(runner)
    torch.save({"params": r2.params.state_dict(), "opt_state": r2.opt_state,
                "metrics": m}, Path(out) / f"{rank}.pt")
    dist.destroy_process_group()


def test_two_rank_scan_step_matches_the_reference_sharded_step(tmp_path):
    """The scan tier on two Gloo ranks against drone_tpu's sharded step on
    two virtual CPU devices (its key folded by the axis index), each rank
    on the reference's draws for its shard: parameters, optimizer moments
    and metrics within test_torch_scan.py's rtol 1e-4 / atol 1e-6."""
    import jax
    import jax.numpy as jnp

    import drone_tpu
    from drone_tpu import ppo as jppo
    from drone_tpu import ppo_pallas
    from drone_tpu.models import ActorCritic as FlaxActorCritic
    from drone_tpu.parallel import make_mesh as jmake_mesh
    from drone_tpu.parallel import make_sharded_train_step as jsharded
    from drone_tpu.parallel.mesh import place_runner as jplace_runner
    from drone_tpu_torch.models import (
        fused_opt_state_from_flax,
        params_from_flax,
    )

    # the clip off, as in EQUIV_TIERS: the first moment is the gradient
    small = dict(horizon=8, num_envs=64, epochs=2, num_minibatches=2,
                 anneal_lr=True, total_updates=10, max_grad_norm=1e9)
    jcfg = jppo.PPOConfig(**small)
    jenv = drone_tpu.DroneEnv()
    fmodel = FlaxActorCritic(hidden=(16, 16))
    jr = jax.jit(lambda: jppo.init_runner(fmodel, jenv, jcfg, seed=1))()
    mesh = jmake_mesh(jax.devices()[:2])
    placed = jplace_runner(mesh, jr)
    jstep = jsharded(fmodel.apply, jppo.make_optimizer(jcfg), jenv.params,
                     jenv.statics, jcfg, mesh, example_runner=placed)
    jr2, jm = jstep(placed)

    local = jcfg.num_envs // 2
    draws = []
    for r in range(2):
        # drone_tpu/ppo.py train_step's splits of the rank's folded key
        _, krollout, kperm = jax.random.split(
            jax.random.fold_in(jr.key, r), 3)
        noise = np.stack([np.asarray(jax.random.normal(k, (local, 4),
                                                       jnp.float32))
                          for k in jax.random.split(krollout, jcfg.horizon)])
        perms = np.stack([np.asarray(jax.random.permutation(k, local))
                          for k in jax.random.split(kperm, jcfg.epochs)])
        draws.append((torch.from_numpy(noise), torch.from_numpy(perms)))
    torch.save({"cfg": small, "draws": draws, "params": params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr.params))},
        tmp_path / "inputs.pt")
    torch.multiprocessing.start_processes(
        _reference_rank, args=(_free_port(), str(tmp_path)), nprocs=2,
        start_method="spawn")

    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jr2.params))
    jcount, jmu, jnu = fused_opt_state_from_flax(
        ppo_pallas.optax_to_fused_opt_state(jr2.opt_state))
    for r in range(2):
        got = torch.load(tmp_path / f"{r}.pt")
        for name, t in got["params"].items():
            np.testing.assert_allclose(t, want[name], rtol=1e-4, atol=1e-6,
                                       err_msg=f"rank {r} {name}")
        count, mu, nu = got["opt_state"]
        assert float(count) == float(jcount) == 4.0
        np.testing.assert_allclose(mu, jmu, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(nu, jnu, rtol=1e-4, atol=1e-6)
        assert set(got["metrics"]) == set(jm)
        for k in jm:
            np.testing.assert_allclose(np.asarray(got["metrics"][k]),
                                       np.asarray(jm[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=f"rank {r} {k}")


def test_shards_are_the_unsharded_lanes():
    """Lane l of rank r is bitwise lane r * local + l of the unsharded
    batch, built alone (init_batch's first_lane) or cut from a runner
    (place_runner), which reseeds the generators of ranks past 0."""
    env = DroneEnv("waypoint", "rk4", device="cpu")
    full = env.init_batch(9, 64)
    cfg = ppo.PPOConfig(num_envs=64)
    model = ActorCritic((16,), generator=torch.Generator().manual_seed(0))
    runner = ppo.init_runner(model, env, cfg, seed=9)
    for r in range(4):
        mesh = Mesh(4, r, torch.device("cpu"))
        sl = mesh.lanes(64)
        shard = env.init_batch(9, 16, first_lane=r * 16)
        assert torch.equal(shard.fstate(), full.fstate()[sl])
        assert torch.equal(shard.key0, full.key0[sl])
        assert runner_sharding(mesh, runner) == {"env_state": sl,
                                                 "last_obs": sl}
        placed = place_runner(mesh, runner)
        assert torch.equal(placed.env_state.fstate(), full.fstate()[sl])
        assert torch.equal(placed.last_obs, runner.last_obs[sl])
        assert placed.params is runner.params
        assert (placed.generator is runner.generator) == (r == 0)
        if r:
            draw = torch.randperm(8, generator=placed.generator)
            assert not torch.equal(draw, torch.randperm(
                8, generator=torch.Generator().manual_seed(9)))


def _rollouts(mesh, state, policy, env):
    k1 = sharded_rollout_cuda(mesh, state, env.params, env.statics, 40)
    k5 = sharded_act_rollout_cuda(mesh, state, policy, env.params,
                                  env.statics, 40)
    return k1, k5


def _unsharded(n):
    env = DroneEnv("hover", params=None, device="cpu")
    env.params.horizon.fill_(25)
    policy = ActorCritic((16, 16), generator=torch.Generator().manual_seed(2))
    state = env.init_batch(5, n)
    return env, policy, state, (
        rollout_cuda(state, env.params, env.statics, 40),
        act_rollout_cuda(state, policy, env.params, env.statics, 40))


def _sharded_rank(rank, port, out):
    """One rank of the two-rank K1/K5 run: its lanes' final states and the
    summed statistics, saved to out/<rank>.pt."""
    torch.set_num_threads(1)
    mesh = initialize_multihost(f"localhost:{port}", 2, rank, "gloo",
                                device="cpu")
    env, policy, state, _ = _unsharded(0)
    state = env.init_batch(5, 32, first_lane=32 * rank)
    (f1, s1), (f5, s5) = _rollouts(mesh, state, policy, env)
    torch.save({"k1": (f1.fstate(), s1), "k5": (f5.fstate(), s5)},
               Path(out) / f"{rank}.pt")
    dist.destroy_process_group()


def test_sharded_k1_k5_over_two_ranks(tmp_path):
    """Two Gloo ranks of 32 lanes each: every rank's final state is its
    lanes of the unsharded run's bit for bit, the summed statistics the
    unsharded run's within rtol 1e-6."""
    torch.multiprocessing.start_processes(
        _sharded_rank, args=(_free_port(), str(tmp_path)), nprocs=2,
        start_method="spawn")
    _, _, _, want = _unsharded(64)
    for k, (final, stats) in zip(("k1", "k5"), want):
        got = [torch.load(tmp_path / f"{r}.pt")[k] for r in range(2)]
        assert torch.equal(torch.cat([g[0] for g in got]), final.fstate())
        assert stats["episodes"] > 0
        for name, v in stats.items():
            for g in got:
                torch.testing.assert_close(g[1][name], v, rtol=1e-6,
                                           atol=0.0)


def test_sharded_k1_k5_world_of_one(world_of_one):
    env, policy, state, want = _unsharded(64)
    got = _rollouts(world_of_one, state, policy, env)
    for (gf, gs), (wf, ws) in zip(got, want):
        assert torch.equal(gf.fstate(), wf.fstate())
        for k in ws:
            assert torch.equal(gs[k], ws[k]), k


def test_sharded_train_step_validates_trainer():
    env = DroneEnv(device="cpu")
    cfg = ppo.PPOConfig(num_envs=256, horizon=4, num_minibatches=2)
    mesh = Mesh(2, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="trainer must be 'scan', 'pallas' "
                                         "or 'pallas_rollout'"):
        make_sharded_train_step(None, env, cfg, mesh, trainer="megakernel")
    with pytest.raises(ValueError, match="recurrent hybrid tier"):
        make_sharded_train_step(None, env, cfg, mesh,
                                trainer="pallas_rollout")
    with pytest.raises(ValueError, match="must divide the mesh size"):
        make_sharded_train_step(None, env, dataclasses.replace(
            cfg, num_envs=255), mesh, trainer="pallas")


def test_run_scaling_over_one_and_two_ranks(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    env = DroneEnv(device="cpu")
    cfg = ppo.PPOConfig(horizon=4, epochs=1, num_minibatches=2)
    recs = run_scaling(env, ActorCritic((16,), generator=torch.Generator()
                                        .manual_seed(0)), cfg,
                       envs_per_device=8, iters=1, device_counts=[1, 2])
    assert [r["devices"] for r in recs] == [1, 2]
    assert [r["num_envs"] for r in recs] == [8, 16]
    assert all(r["steps_per_s"] > 0 for r in recs)
    assert recs[0]["efficiency"] == 1.0 and recs[1]["efficiency"] > 0


def test_two_rank_cli_train_checkpoints_the_global_runner(tmp_path):
    """`cli train` in two processes with torchrun's environment: the
    checkpoint holds all 512 lanes in rank order (each lane's key that of
    the unsharded batch), rank 1's generators beside rank 0's, and only
    rank 0 logs."""
    port = _free_port()
    args = [sys.executable, "-m", "drone_tpu_torch.cli", "train",
            "--device", "cpu", "train.num_envs=512", "train.horizon=8",
            "train.num_minibatches=2", "train.epochs=1", "run.hidden=16,16",
            "run.total_updates=2", "run.log_interval=1",
            f"run.checkpoint_dir={tmp_path}", "run.run_name=ddp"]
    procs = [subprocess.Popen(
        args, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_child_env(RANK=str(r), LOCAL_RANK=str(r),
                                  WORLD_SIZE="2", MASTER_ADDR="localhost",
                                  MASTER_PORT=str(port)))
        for r in range(2)]
    outs = _communicate(procs)
    assert "upd 2/2" in outs[0], outs[0][-2000:]
    assert "upd " not in outs[1], outs[1][-2000:]
    raw, step = Checkpointer(tmp_path / "ddp" / "checkpoints").restore_raw()
    assert step == 2
    assert raw["env_state"]["pos"].shape == (512, 3)
    want = DroneEnv(device="cpu").init_batch(0, 512)
    assert torch.equal(raw["env_state"]["key0"], want.key0)
    assert len(raw["rank_generators"]) == 1
    lines = (tmp_path / "ddp" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2


RESUME_RUNS = {
    "megakernel": ["train.num_envs=512", "train.horizon=8",
                   "train.num_minibatches=2", "train.epochs=1",
                   "run.hidden=16,16"],
    "scan": ["run.rollout=scan", "train.num_envs=32", "train.horizon=4",
             "train.num_minibatches=2", "train.epochs=1",
             "run.hidden=16,16"],
}


def _resume_rank(rank, port, out):
    """One rank of three two-rank runs of each tier: 4 updates straight,
    2 updates, and those 2 resumed to 4."""
    torch.set_num_threads(1)
    initialize_multihost(f"localhost:{port}", 2, rank, "gloo", device="cpu")
    for kind, overrides in RESUME_RUNS.items():
        base = Config.default().with_overrides(
            overrides + [f"run.checkpoint_dir={out}", "run.log_interval=1"])
        for name, total, extra in (
                ("full", 4, []), ("half", 2, []),
                ("resumed", 4, [f"run.resume_from={out}/{kind}-half/"
                                f"checkpoints"])):
            train.train(base.with_overrides(
                [f"run.run_name={kind}-{name}", f"run.total_updates={total}",
                 f"run.checkpoint_interval={total}"] + extra), device="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_rank_resumes(tmp_path_factory):
    out = tmp_path_factory.mktemp("two_rank_resumes")
    torch.multiprocessing.start_processes(
        _resume_rank, args=(_free_port(), str(out)), nprocs=2,
        start_method="spawn")
    return out


def _same(a, b, where):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("kind", list(RESUME_RUNS))
def test_two_rank_resume_is_the_uninterrupted_run(kind, two_rank_resumes):
    """Two ranks train 2 updates and checkpoint; resumed to 4, each rank
    takes its lanes and its generators back, and the checkpoint at 4 is the
    uninterrupted two-rank run's bit for bit: parameters, optimizer state,
    the global lanes and every rank's generators."""
    full, step = Checkpointer(
        two_rank_resumes / f"{kind}-full" / "checkpoints").restore_raw()
    resumed, rstep = Checkpointer(
        two_rank_resumes / f"{kind}-resumed" / "checkpoints").restore_raw()
    assert step == rstep == 4
    assert len(full["rank_generators"]) == 1
    # the resumed run trained updates 3 and 4 alone
    for name, n in (("full", 4), ("resumed", 2)):
        log = two_rank_resumes / f"{kind}-{name}" / "metrics.jsonl"
        assert len(log.read_text().splitlines()) == n, name
    _same(full, resumed, "checkpoint")


def test_restore_takes_the_rank_lanes_of_its_world(tmp_path):
    """Restored under a mesh, each rank takes its lanes of the saved global
    runner and its own generators; a checkpoint of another world size is
    refused."""
    env = DroneEnv(device="cpu")
    cfg = ppo.PPOConfig(num_envs=64, horizon=4)
    model = ActorCritic((16,), generator=torch.Generator().manual_seed(0))
    full = ppo.init_runner(model, env, cfg, seed=3)
    other = (torch.Generator().manual_seed(11).get_state(),
             torch.Generator().manual_seed(12).get_state())
    ckpt = Checkpointer(tmp_path / "two")
    ckpt.save(1, full, [other])
    for r in range(2):
        mesh = Mesh(2, r, torch.device("cpu"))
        template = place_runner(mesh, ppo.init_runner(
            model, env, cfg, seed=5))
        got, step = ckpt.restore(template, mesh=mesh)
        assert step == 1
        sl = mesh.lanes(64)
        assert torch.equal(got.env_state.fstate(),
                           full.env_state.fstate()[sl])
        want = (full.generator.get_state(),
                full.noise_generator.get_state()) if r == 0 else other
        assert torch.equal(got.generator.get_state(), want[0])
        assert torch.equal(got.noise_generator.get_state(), want[1])
    for mesh, saved in ((Mesh(4, 1, torch.device("cpu")), ckpt),
                        (None, ckpt),
                        (Mesh(2, 1, torch.device("cpu")),
                         Checkpointer(tmp_path / "one"))):
        if saved is not ckpt:
            saved.save(1, full)
        template = full if mesh is None else place_runner(mesh, full)
        with pytest.raises(RuntimeError, match="saved by"):
            saved.restore(template, mesh=mesh)


def _cpu_rank_on_a_card_host(rank, port, out):
    """initialize_multihost(device="cpu") where CUDA is reported present:
    the backend and the mesh's device, and whether a card was selected."""
    calls = []
    torch.cuda.is_available = lambda: True
    torch.cuda.set_device = calls.append
    mesh = initialize_multihost(f"localhost:{port}", 1, 0, device="cpu")
    torch.save({"backend": dist.get_backend(), "device": str(mesh.device),
                "set_device": len(calls)}, Path(out) / "init.pt")
    dist.destroy_process_group()


def test_initialize_multihost_on_the_cpu_touches_no_card(tmp_path):
    """A CPU run on a host with cards (`cli train --device cpu` under
    torchrun) takes Gloo and the CPU and selects no card."""
    torch.multiprocessing.start_processes(
        _cpu_rank_on_a_card_host, args=(_free_port(), str(tmp_path)),
        nprocs=1, start_method="spawn")
    got = torch.load(tmp_path / "init.pt")
    assert got == {"backend": "gloo", "device": "cpu", "set_device": 0}
