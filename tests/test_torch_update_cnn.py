"""K10 (the CNN PPO update), K4 over the CNN layout and the CNN trainer:
plain versions against drone_tpu's.

`ppo_cnn_update_cuda` runs its plain version on CPU tensors. It is held to
`pallas_update_cnn.ppo_cnn_update(mode="reference")` on the same planes and
a shuffled row-block minibatch, at the weights that wrote the planes and
off them (every branch of the head's subgradients taken), and to
`torch.autograd` of the same PPO loss, as tests/test_pallas_cnn.py holds
the reference to jax.grad: each gradient tensor within 1e-4 of its largest
|value| (the sums run in another order, and the plain version walks the
samples in chunks), the stat sums within rtol 1e-4 / atol 2e-5 (two of
them cancel to ~0). One whole train step is held to
`make_pallas_cnn_train_step(mode="reference", fused_optimizer=True)` under
the reference's own permutations: params, optimizer state and metrics
within rtol 1e-4 / atol 1e-6. The reference's small geometry (res 8, 2x2
patches, channels (8, 8), hidden 16) keeps them fast; the trainer's entry
points run at the default geometry, which the kernels take.
"""

import functools
import math
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import drone_tpu
from drone_tpu import pixels as jpixels
from drone_tpu import ppo as jppo
from drone_tpu import ppo_cnn_pallas as PCP
from drone_tpu import ppo_pallas
from drone_tpu.models import PatchCNNActorCritic as FlaxCNN
from drone_tpu.ops import pallas_acting_cnn as PAC
from drone_tpu.ops import pallas_acting_traj as PAT
from drone_tpu.ops import pallas_update as PU
from drone_tpu.ops import pallas_update_cnn as PUC
from drone_tpu_torch import cli, ppo_cnn_cuda, ppo_cuda, train
from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import (
    PatchCNNActorCritic,
    fused_opt_state_from_flax,
    tensor_sizes,
)
from drone_tpu_torch.models.cnn import (
    cnn_all_weights,
    cnn_kernel_order,
    fused_opt_state_to_flax,
    params_from_flax,
    params_to_flax,
)
from drone_tpu_torch.ops import (
    cuda_update,
    cuda_update_cnn,
    fused_adam_cuda,
    ppo_cnn_update_cuda,
)
from drone_tpu_torch.ops.cuda_acting_cnn import cnn_forward
from drone_tpu_torch.ops.cuda_acting_traj import HALF_LOG_2PI
from drone_tpu_torch.pixels import patch_grid
from drone_tpu_torch.ppo import PPOConfig, init_fused_opt_state, init_runner
from drone_tpu_torch.utils.checkpoint import Checkpointer
from drone_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
HOVER = ROOT / "configs" / "hover.toml"
SMALL = dict(res=8, patch0=2, patch1=2, channels=(8, 8), hidden=16)
GEOM = PAC.CnnGeom(8, 2, 2)
N, T = 256, 8


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference(seed=0):
    """A reference CNN rollout's planes (episodes of 6 steps), GAE
    advantages and the flax weights that wrote them."""
    env = drone_tpu.DroneEnv()
    fm = FlaxCNN(**SMALL)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(fm.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 13), jnp.float32)))
    p = env.params.replace(horizon=jnp.int32(6))
    final, traj, _ = jax.jit(
        lambda s, pp, prm: PAC.traj_cnn_rollout_reference(
            s, prm, pp, env.statics, T, geom=GEOM))(env.init_batch(3, N), p,
                                                    params)
    rows = N // 128
    planes = PAT.pack_traj_planes(traj, rows)
    gx, gy = jpixels.patch_grid(8, 2)
    _, lv = PAC.cnn_forward(env.observe_batch(final).T,
                            PAC.cnn_all_weights(params, GEOM), gx, gy, GEOM,
                            jnp.float32)
    advret = ppo_pallas.normalized_advret(planes, lv[0].reshape(rows, 128),
                                          jppo.PPOConfig(), None)
    return params, np.asarray(planes), np.asarray(advret)


def _fixture(vf_clip=10.0):
    params, planes, advret = _reference()
    model = PatchCNNActorCritic(**SMALL)
    model.load_state_dict(params_from_flax(params))
    model.flatten_()
    co = PU.UpdateConsts(clip_eps=0.2, vf_clip=vf_clip, vf_coef=0.5,
                         inv_m=1.0 / (N * T))
    return params, model, planes, advret, co


def _port_args(planes, advret, perm, model, co):
    return (torch.tensor(planes).reshape(T, -1, N),
            torch.tensor(advret).reshape(2, T, N),
            torch.from_numpy(np.asarray(perm, np.int32)), model.flat,
            model.arch, cuda_update.UpdateConsts(co.clip_eps, co.vf_clip,
                                                 co.vf_coef, co.inv_m), 128)


def _check_tensors(got, want_list, order):
    """Each tensor of `order` within 1e-4 of its largest |value|."""
    off = 0
    for (name, shape), want in zip(order, want_list):
        n = math.prod(shape)
        want = np.asarray(want).reshape(-1)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got[off:off + n].numpy(), want, rtol=0,
                                   atol=2e-7 + 1e-4 * scale, err_msg=name)
        off += n


def _update_against_reference(params, model, planes, advret, co,
                              monkeypatch):
    perm = np.array([1, 0], np.int32)
    tensors = PCP.cnn_kernel_tensors(params, GEOM)
    gx, gy = jpixels.patch_grid(8, 2)
    want, st = PUC.ppo_cnn_update(
        jnp.asarray(planes), jnp.asarray(advret), jnp.asarray(perm),
        tensors[:-1], tensors[-1], gx, gy, tc=1, geom=GEOM, co=co, rbu=1,
        mode="reference")
    launches = ppo_cnn_update_cuda.launches
    # chunks that do not divide the minibatch's 2,048 samples
    monkeypatch.setattr(cuda_update_cnn, "PLAIN_CHUNK", 600)
    args = _port_args(planes, advret, perm, model, co)
    grads, stats = ppo_cnn_update_cuda(*args)
    assert ppo_cnn_update_cuda.launches == launches  # CPU tensors: no kernel
    st = np.asarray(st)
    _check_tensors(grads, [*want, st[PU.ST_DLS0:]], cnn_kernel_order(
        model.arch))
    # on-policy the policy-loss and approx-KL sums cancel to ~0 over 2,048
    # samples of order 1, so their rounding in another order is absolute
    np.testing.assert_allclose(stats.numpy(), st, rtol=1e-4, atol=2e-5)
    return stats


def test_plain_update_matches_reference(monkeypatch):
    params, model, planes, advret, co = _fixture()
    _update_against_reference(params, model, planes, advret, co, monkeypatch)


def test_plain_update_matches_reference_off_policy(monkeypatch):
    """At weights moved off the planes' (noise on both heads, log_std up by
    0.1, a narrow vf_clip) every branch of the head's subgradients is
    taken, and the approx-KL and clip-fraction sums are nonzero."""
    _, model, planes, advret, co = _fixture(vf_clip=0.2)
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p, scale in ((model.actor_mean.weight, 0.3),
                         (model.actor_mean.bias, 0.3),
                         (model.critic_value.weight, 0.5),
                         (model.critic_value.bias, 0.5)):
            p += torch.from_numpy(
                (scale * rng.normal(size=tuple(p.shape))).astype(np.float32))
        model.log_std += 0.1
    args = _port_args(planes, advret, [1, 0], model, co)
    n = cuda_update_cnn.cnn_head_branch_counts(*args)
    assert n["ratio_out"] > n["policy_grad_zero"] > 0, n
    assert n["value_out"] > n["value_grad_zero"] > 0, n
    params = jax.tree_util.tree_map(jnp.asarray, params_to_flax(model))
    stats = _update_against_reference(params, model, planes, advret, co,
                                      monkeypatch)
    assert float(stats[cuda_update.ST_KL]) != 0.0
    assert float(stats[cuda_update.ST_CF]) > 0.0


def test_plain_update_matches_torch_autograd():
    """The hand-written conv backward against torch.autograd of the same
    PPO loss on the kernels' plane-space forward, log_std with its entropy
    term."""
    _, model, planes, advret, co = _fixture()
    ent_coef = 0.01
    args = _port_args(planes, advret, [0, 1], model, co)
    grads, _ = ppo_cnn_update_cuda(*args, ent_coef=ent_coef)
    theta = model.flat.detach().clone().requires_grad_(True)
    X, a, logp_old, v_old, adv, ret = cuda_update.gather_minibatch(
        args[0], args[1], args[2], 128)
    w = cnn_all_weights(theta, model.arch)
    m, v = cnn_forward(X, w, *patch_grid(8, 2), model.arch.geom)
    ls = w[8]
    z = (a - m) / torch.exp(ls)
    logp = torch.sum(-0.5 * z * z - ls - HALF_LOG_2PI, 1)
    ratio = torch.exp(logp - logp_old)
    pg = torch.maximum(-adv * ratio, -adv * torch.clamp(ratio, 0.8, 1.2))
    v_clip = v_old + torch.clamp(v - v_old, -10.0, 10.0)
    v_loss = 0.5 * torch.mean(torch.maximum((v - ret) ** 2,
                                            (v_clip - ret) ** 2))
    ent = torch.sum(ls + 0.5 * (1.0 + 2.0 * HALF_LOG_2PI))
    loss = torch.mean(pg) + 0.5 * v_loss - ent_coef * ent
    want, = torch.autograd.grad(loss, theta)
    views = cnn_all_weights(want.detach(), model.arch)
    _check_tensors(grads, [*views[:6], *views[6], *views[7], views[8]],
                   cnn_kernel_order(model.arch))


def test_update_log_std_gradient_carries_the_entropy_term():
    _, model, planes, advret, co = _fixture()
    args = _port_args(planes, advret, [0], model, co)
    g0, st0 = ppo_cnn_update_cuda(*args)
    g1, st1 = ppo_cnn_update_cuda(*args, ent_coef=0.25)
    assert torch.equal(st0, st1) and torch.equal(g0[:-4], g1[:-4])
    torch.testing.assert_close(g1[-4:], st0[cuda_update.ST_DLS0:] - 0.25)


def test_kernel_refuses_cpu_tensors_and_other_shapes():
    _, model, planes, advret, co = _fixture()
    with pytest.raises(ValueError, match="PatchCNNActorCritic defaults"):
        cuda_update_cnn.ppo_cnn_update_kernel(
            *_port_args(planes, advret, [0], model, co))
    big = PatchCNNActorCritic()
    big.flatten_()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_update_cnn.ppo_cnn_update_kernel(
            torch.tensor(planes).reshape(T, -1, N),
            torch.tensor(advret).reshape(2, T, N),
            torch.zeros(1, dtype=torch.int32), big.flat, big.arch,
            cuda_update.UpdateConsts(0.2, 10.0, 0.5, 1e-3), 128)
    assert cuda_update_cnn.pick_chunk_steps(128, 16384) == 16
    assert cuda_update_cnn.chunk_lanes(16384) == 4096


def test_plain_adam_over_the_cnn_layout_matches_reference():
    params, model, *_ = _fixture()
    tensors = PCP.cnn_kernel_tensors(params, GEOM)
    rng = np.random.default_rng(3)
    grads, mus, nus = ([s * f(size=np.shape(t)).astype(np.float32)
                        for t in tensors]
                       for s, f in ((0.05, rng.normal), (0.01, rng.normal),
                                    (0.001, rng.uniform)))
    jcfg = jppo.PPOConfig(total_updates=10, epochs=2, num_minibatches=4,
                          anneal_lr=True)
    lr = ppo_pallas.make_fused_lr(jcfg)(jnp.float32(5.0))
    w2, mu2, nu2 = PU.fused_adam([jnp.asarray(g) for g in grads], tensors,
                                 [jnp.asarray(m) for m in mus],
                                 [jnp.asarray(v) for v in nus], lr, 5.0,
                                 ac=PU.AdamConsts(clip_norm=0.5),
                                 mode="reference")
    count, mu, nu = fused_opt_state_from_flax((np.float32(5.0), mus, nus))
    g = fused_opt_state_from_flax((0.0, grads, grads))[1]
    theta = model.flat
    fused_adam_cuda(theta, g, mu, nu, count, cuda_update.AdamConsts(),
                    ppo_cuda.make_fused_lr(PPOConfig(
                        total_updates=10, epochs=2, num_minibatches=4,
                        anneal_lr=True)),
                    tensor_sizes(model.kernel_order()))
    assert float(count) == 6.0
    cat = lambda ts: np.concatenate([np.asarray(t).reshape(-1)  # noqa: E731
                                     for t in ts])
    for got, want in ((theta, w2), (mu, mu2), (nu, nu2)):
        np.testing.assert_allclose(got.numpy(), cat(want), rtol=1e-5,
                                   atol=1e-8)


def test_fused_opt_state_converters_round_trip():
    params, model, *_ = _fixture()
    _, mu, nu = PCP.init_fused_opt_state(params, GEOM)
    rng = np.random.default_rng(0)
    mu = [rng.normal(size=np.shape(t)).astype(np.float32) for t in mu]
    nu = [rng.uniform(size=np.shape(t)).astype(np.float32) for t in nu]
    state = fused_opt_state_from_flax((np.float32(9.0), mu, nu))
    assert state[1].shape == model.flat.shape
    c2, mu2, nu2 = fused_opt_state_to_flax(state, model.arch)
    assert float(c2) == 9.0
    for a, b in zip(mu + nu, mu2 + nu2):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


SMALL_CFG = dict(horizon=T, num_envs=N, epochs=2, num_minibatches=2,
                 anneal_lr=True, total_updates=10)


def _close(a, b, err):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-6, err_msg=err)


def test_train_step_matches_reference_trainer():
    jcfg = jppo.PPOConfig(**SMALL_CFG)
    jenv = drone_tpu.DroneEnv()
    fm = FlaxCNN(**SMALL)
    jr = jppo.init_runner(fm, jenv, jcfg, seed=1)
    jr = jr.replace(opt_state=PCP.init_fused_opt_state(jr.params, GEOM))
    jstep = jax.jit(PCP.make_pallas_cnn_train_step(
        jppo.make_optimizer(jcfg), jenv.params, jenv.statics, jcfg,
        geom=GEOM, mode="reference", fused_optimizer=True))
    _, kperm = jax.random.split(jr.key)
    n_rb = ppo_cuda.plan_minibatch_geometry(PPOConfig(**SMALL_CFG), N)[3]
    perms = np.stack([np.asarray(jax.random.permutation(k, n_rb))
                      for k in jax.random.split(kperm, jcfg.epochs)])
    jr2, jm = jstep(jr)

    env = tenv.DroneEnv(device="cpu")
    model = PatchCNNActorCritic(**SMALL)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr.params)))
    runner = init_runner(model, env, PPOConfig(**SMALL_CFG), seed=1)
    step = ppo_cnn_cuda.make_cnn_train_step(env, PPOConfig(**SMALL_CFG),
                                            permutations=lambda r: perms)
    r2, m = step(runner)

    assert set(m) == set(jm) == set(ppo_cuda.METRIC_KEYS)
    for k in jm:
        _close(m[k], jm[k], k)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jr2.params))
    for name, t in r2.params.state_dict().items():
        _close(t, want[name], name)
    count, mu, nu = fused_opt_state_to_flax(r2.opt_state, model.arch)
    jcount, jmu, jnu = jr2.opt_state
    assert float(count) == float(jcount) == 4.0
    for i, (a, b) in enumerate(zip(mu + nu, list(jmu) + list(jnu))):
        assert a.shape == np.asarray(b).shape
        _close(a, b, f"moment {i}")
    assert r2.update_idx == int(jr2.update_idx) == 1
    assert ppo_cnn_cuda.cnn_geom(model) == model.arch.geom
    assert init_fused_opt_state(model.flat)[1].shape == model.flat.shape


def _cfg(tmp_path, name, total, extra=()):
    return Config.default().with_overrides([
        "run.policy=cnn", f"train.num_envs={N}", "train.horizon=4",
        "train.epochs=2", "train.num_minibatches=2", "run.log_interval=1",
        "run.checkpoint_interval=100", f"run.total_updates={total}",
        f"run.run_name={name}", f"run.checkpoint_dir={tmp_path}", *extra])


def test_cnn_resume_is_bitwise(tmp_path):
    """train(4) == train(2) + resume(2) at the default geometry: every
    tensor of the runner, through a checkpoint round trip."""
    full, _ = train.train(_cfg(tmp_path, "full", 4), device="cpu")
    train.train(_cfg(tmp_path, "half", 2), device="cpu")
    ckpt = tmp_path / "half" / "checkpoints"
    raw, step = Checkpointer(ckpt).restore_raw()
    assert step == 2 and raw["params"]["conv1.weight"].shape == (64, 256)
    resumed, last = train.train(
        _cfg(tmp_path, "resumed", 4, [f"run.resume_from={ckpt}"]),
        device="cpu")
    assert resumed.update_idx == full.update_idx == 4

    def tensors(r):
        return [*r.params.state_dict().values(), *r.opt_state,
                r.env_state.fstate(), r.env_state.step,
                r.generator.get_state()]

    for a, b in zip(tensors(full), tensors(resumed)):
        assert torch.equal(a, b)
    assert np.isfinite(last["loss"])


def test_cli_train_then_eval_cnn_on_cpu(tmp_path, capsys):
    over = ["--device", "cpu", "run.policy=cnn"]
    assert cli.main(["train", str(HOVER), *over, f"train.num_envs={N}",
                     "train.horizon=4", "train.num_minibatches=2",
                     "train.epochs=1", "run.total_updates=2",
                     f"run.checkpoint_dir={tmp_path}", "run.run_name=cli"]) == 0
    capsys.readouterr()
    assert cli.main(["eval", str(HOVER), *over,
                     f"run.resume_from={tmp_path}/cli/checkpoints",
                     "env.params.horizon=6"]) == 0
    assert '"episodes"' in capsys.readouterr().out


# run.rollout=scan and train.num_envs=384 train on the scan trainer:
# test_torch_scan.py test_build_picks_the_trainer. bf16 training builds on
# the CNN megakernel trainer (K9's and K10's bf16 arms, their plain
# versions here) and trains an update; held to the reference's in
# test_torch_bf16.py
@pytest.mark.parametrize("override,match", [
    ("run.compute_dtype=bfloat16", "bf16 training"),
])
def test_unported_cnn_training_options_name_their_roadmap_item(
        tmp_path, override, match):
    del match
    env, model, runner, step, cfg = train.build(
        _cfg(tmp_path, "x", 1, [override]), device="cpu")
    assert train.trainer_kind(cfg, model) == "megakernel"
    theta = model.flat.clone()
    runner, m = step(runner)
    assert runner.update_idx == 1 and np.isfinite(float(m["loss"]))
    assert not torch.equal(theta, model.flat)
    # evaluate serves a bf16 CNN through the module, as the reference does
    stats = train.evaluate(cfg.with_overrides(["env.params.horizon=4"]),
                           runner=runner, episodes=128, device="cpu")
    assert stats["episodes"] >= 128
