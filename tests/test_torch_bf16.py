"""bfloat16 training (run.compute_dtype=bfloat16): the plain versions of the
bf16 operand arms of K2, K3, K9 and K10, one whole megakernel train step of
the MLP and the CNN family, and one scan step of ActorCritic(dtype=
bfloat16), against drone_tpu's bf16 references on the same weights (carried
across by `params_from_flax`) and inputs, on the CPU.

Tolerances (H12). The bf16 arm rounds both operands of every product to
bfloat16 and sums in float32, as the reference's `_dot32`. torch and XLA
differ by a few ulp in tanh, exp and log and sum in other orders, so an
fp32 activation within those ulps of a bf16 rounding boundary rounds to
neighbouring bf16 values on the two sides: one term of a sum then moves by
2^-8 of its size. Most values agree as closely as the fp32 arms' (rtol
2e-5 / atol 2e-6, CLOSE), a few do not. So a rollout's planes are held to:
at least MIN_SHARE of the values within CLOSE, the largest difference
within a bound measured on these inputs (the flips' 1.3e-3 to 5.4e-3 on
K2's, printed by the assertion), and the mean difference to the reference's
bf16 result under SEPARATION of its mean difference to the reference's
fp32 result (measured: ~1e-3 of it), so a port that quietly stayed in fp32
fails. Gradients: each tensor within GRAD_REL of its largest |value|, and
the same separation.
"""

import functools
import math

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
from drone_tpu.models import ActorCritic as FlaxActorCritic
from drone_tpu.models import PatchCNNActorCritic as FlaxCNN
from drone_tpu.ops import pallas_acting_cnn as PAC
from drone_tpu.ops import pallas_acting_traj as PAT
from drone_tpu.ops import pallas_update as PU
from drone_tpu.ops import pallas_update_cnn as PUC
from drone_tpu.ops.pallas_acting import actor_weights
from drone_tpu_torch import env as tenv
from drone_tpu_torch import ppo, ppo_cnn_cuda, ppo_cuda
from drone_tpu_torch import types as ttypes
from drone_tpu_torch.models import (
    ActorCritic,
    PatchCNNActorCritic,
    fused_opt_state_from_flax,
    kernel_order,
    params_from_flax,
)
from drone_tpu_torch.models import cnn as tcnn
from drone_tpu_torch.ops import (
    cuda_acting_traj,
    cuda_update,
    ppo_cnn_update_cuda,
    ppo_update_cuda,
    traj_cnn_rollout_cuda,
    traj_rollout_cuda,
)
from drone_tpu_torch.ppo import PPOConfig, init_runner
from tests.helpers import pack_fstate_batch

BF16 = "bfloat16"
CLOSE = (2e-5, 2e-6)
MIN_SHARE = 0.99
SEPARATION = 0.1
GRAD_REL = 1e-3
MOMENT_REL = 1e-2
SMALL = dict(horizon=8, num_envs=256, epochs=2, num_minibatches=2,
             anneal_lr=True, total_updates=10)
CNN_SMALL = dict(res=8, patch0=2, patch1=2, channels=(8, 8), hidden=16)
GEOM = PAC.CnnGeom(8, 2, 2)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_close(got, want16, want32, max_err, what):
    """H12's rule on one array: MIN_SHARE within CLOSE, every value within
    max_err, the mean difference under SEPARATION of the fp32 one's."""
    got, want16, want32 = (np.asarray(x, np.float64)
                           for x in (got, want16, want32))
    d16, d32 = np.abs(got - want16), np.abs(got - want32)
    share = np.mean(d16 <= CLOSE[1] + CLOSE[0] * np.abs(want16))
    msg = (f"{what}: share {share:.5f}, max {d16.max():.3g}, mean "
           f"{d16.mean():.3g} against the fp32 reference's {d32.mean():.3g}")
    assert share >= MIN_SHARE, msg
    assert d16.max() <= max_err, msg
    assert d16.mean() <= SEPARATION * d32.mean(), msg


def _grads_close(got, want16, want32, order, what):
    """Each tensor of `order` within GRAD_REL of its largest |value|; the
    mean difference under SEPARATION of the fp32 reference's."""
    got, want16, want32 = (np.asarray(x, np.float64).reshape(-1)
                           for x in (got, want16, want32))
    off = 0
    for name, shape in order:
        n = math.prod(shape)
        scale = np.abs(want16[off:off + n]).max()
        np.testing.assert_allclose(got[off:off + n], want16[off:off + n],
                                   rtol=0, atol=GRAD_REL * scale,
                                   err_msg=f"{what} {name}")
        off += n
    d16, d32 = np.abs(got - want16).mean(), np.abs(got - want32).mean()
    assert d16 <= SEPARATION * d32, (what, d16, d32)


def _traj_planes(traj):
    """A reference Traj as the port's (T, 21, N) planes."""
    return np.concatenate([
        np.asarray(traj.obs).transpose(0, 2, 1),
        np.asarray(traj.action).transpose(0, 2, 1),
        np.asarray(traj.logp)[:, None], np.asarray(traj.value)[:, None],
        np.asarray(traj.reward)[:, None],
        np.asarray(traj.done, np.float32)[:, None]], axis=1)


def _mlp_policies(hidden, seed=0, log_std=-0.5):
    """The same weights in both packages; actions of order 1."""
    params = FlaxActorCritic(hidden=hidden).init(jax.random.PRNGKey(seed),
                                                 jnp.zeros((1, 13)))
    p = jax.tree_util.tree_map(np.asarray, params)["params"]
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(
        size=(p["actor_mean"]["kernel"].shape[0], 4)))
    p["actor_mean"]["kernel"] = q.astype(np.float32)
    p["log_std"] = np.full(4, log_std, np.float32)
    model = ActorCritic(hidden)
    model.load_state_dict(params_from_flax({"params": p}))
    model.flatten_()
    return {"params": p}, model


@functools.lru_cache(maxsize=None)
def _mlp_reference(stochastic=True, N=512, T=3):
    """The reference's bf16 and fp32 rollouts (traj_act_rollout_reference)
    of one policy over episodes of 2 steps, with the port's inputs."""
    jp = drone_tpu.types.default_params("hover", horizon=2)
    jenv = drone_tpu.DroneEnv(params=jp)
    fparams, model = _mlp_policies((32, 32))
    run = jax.jit(functools.partial(
        PAT.traj_act_rollout_reference, statics=jenv.statics, T=T,
        stochastic=stochastic), static_argnames=("compute_dtype",))
    out = {cd: run(jenv.init_batch(3, N), fparams, jp, compute_dtype=cd)
           for cd in ("float32", BF16)}
    return fparams, model, out


def test_plain_bf16_traj_matches_reference():
    stochastic = True
    fparams, model, out = _mlp_reference(stochastic)
    N, T = 512, 3
    env = tenv.DroneEnv(params=ttypes.default_params(horizon=2),
                        device="cpu")
    launches = traj_rollout_cuda.launches
    final, planes, stats = traj_rollout_cuda(
        env.init_batch(3, N), model.flat, model.hidden, env.params,
        env.statics, T, stochastic=stochastic, compute_dtype=BF16)
    assert traj_rollout_cuda.launches == launches  # CPU tensors: no kernel
    j_final, j_traj, j_stats = out[BF16]
    _bf16_close(planes, _traj_planes(j_traj), _traj_planes(out["float32"][1]),
                1e-2, "K2 planes")
    _bf16_close(final.fstate(), pack_fstate_batch(j_final),
                pack_fstate_batch(out["float32"][0]), 1e-3, "K2 final state")
    assert float(stats["episodes"]) == float(j_stats["episodes"]) >= N


def _advret(planes, seed=2):
    """Random normalized advantages over the planes, returns = value + adv
    / 2: (2, T, N)."""
    T, _, N = planes.shape
    adv = np.random.default_rng(seed).normal(size=(T, N)).astype(np.float32)
    return np.stack([adv, planes[:, PAT.TP_VAL] + np.float32(0.5) * adv])


def _off_policy(fparams, model):
    """The same weights moved off the planes' (noise on both heads, log_std
    up by 0.1) in both packages: every branch of the head's subgradients."""
    p = jax.tree_util.tree_map(np.array, fparams)["params"]
    rng = np.random.default_rng(5)
    for head, scale in (("actor_mean", 0.05), ("critic_value", 2.0)):
        for k in ("kernel", "bias"):
            p[head][k] = (p[head][k] + scale * rng.normal(
                size=p[head][k].shape)).astype(np.float32)
    p["log_std"] = p["log_std"] + np.float32(0.1)
    moved = ActorCritic(model.hidden)
    moved.load_state_dict(params_from_flax({"params": p}))
    moved.flatten_()
    return {"params": p}, moved


@functools.lru_cache(maxsize=None)
def _jax_update(compute_dtype):
    return jax.jit(functools.partial(PU.ppo_update, tc=3, mode="reference",
                                     compute_dtype=compute_dtype),
                   static_argnames=("co",))


@pytest.mark.parametrize("off_policy", [False, True])
def test_plain_bf16_update_matches_reference(off_policy):
    """K3's plain bf16 arm on the planes of the bf16 rollout: at their
    weights (ratio 1) and off them."""
    fparams, model, out = _mlp_reference(True)
    planes = _traj_planes(out[BF16][1])
    T, _, N = planes.shape
    advret = _advret(planes)
    if off_policy:
        fparams, model = _off_policy(fparams, model)
    co = PU.UpdateConsts(clip_eps=0.2, vf_clip=0.5, vf_coef=0.5,
                         inv_m=1.0 / (N // 2 * T))
    perm = np.array([3, 0], np.int32)
    rows = N // 128
    jargs = (jnp.asarray(planes.reshape(T, -1, rows, 128)),
             jnp.asarray(advret.reshape(2, T, rows, 128)), jnp.asarray(perm),
             actor_weights(fparams), PAT.critic_weights(fparams),
             PAT._log_std(fparams))
    want = {}
    for cd in ("float32", BF16):
        (ga, gc), st = _jax_update(cd)(*jargs, co=co)
        want[cd] = np.concatenate(
            [np.asarray(t).reshape(-1) for wb in (*ga, *gc) for t in wb]
            + [np.asarray(st)[PU.ST_DLS0:]]), np.asarray(st)
    launches = ppo_update_cuda.launches
    grads, stats = ppo_update_cuda(
        torch.from_numpy(planes), torch.from_numpy(advret),
        torch.from_numpy(perm), model.flat, model.hidden,
        cuda_update.UpdateConsts(co.clip_eps, co.vf_clip, co.vf_coef,
                                 co.inv_m), rbl=128, compute_dtype=BF16)
    assert ppo_update_cuda.launches == launches  # CPU tensors: no kernel
    _grads_close(grads, want[BF16][0], want["float32"][0],
                 kernel_order(model.hidden), "K3")
    np.testing.assert_allclose(stats.numpy(), want[BF16][1], rtol=GRAD_REL,
                               atol=1e-4 * np.abs(want[BF16][1]).max())
    branches = cuda_update.head_branch_counts(
        torch.from_numpy(planes), torch.from_numpy(advret),
        torch.from_numpy(perm), model.flat, model.hidden,
        cuda_update.UpdateConsts(co.clip_eps, co.vf_clip, co.vf_coef,
                                 co.inv_m), 128, compute_dtype=BF16)
    if off_policy:
        assert min(branches.values()) > 0, branches
    else:  # the stored logp is the bf16 forward's: ratio 1
        assert branches["ratio_out"] == 0, branches


@functools.lru_cache(maxsize=None)
def _cnn_reference(stochastic=True, N=256, T=3):
    """The reference's bf16 and fp32 CNN rollouts (small geometry,
    episodes of 2 steps) of one policy, with the port's copy of it."""
    jp = drone_tpu.types.default_params("hover", horizon=2)
    jenv = drone_tpu.DroneEnv(params=jp)
    fm = FlaxCNN(**CNN_SMALL)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(fm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 13), jnp.float32)))
    model = PatchCNNActorCritic(**CNN_SMALL)
    model.load_state_dict(tcnn.params_from_flax(params))
    model.flatten_()
    run = jax.jit(functools.partial(
        PAC.traj_cnn_rollout_reference, statics=jenv.statics, T=T,
        geom=GEOM, stochastic=stochastic), static_argnames=("compute_dtype",))
    out = {cd: run(jenv.init_batch(3, N), params, jp, compute_dtype=cd)
           for cd in ("float32", BF16)}
    return params, model, out


def _cnn_copy(model):
    copy = PatchCNNActorCritic(**CNN_SMALL)
    copy.load_state_dict(model.state_dict())
    copy.flatten_()
    return copy


def test_plain_bf16_cnn_traj_matches_reference():
    params, model, out = _cnn_reference()
    N, T = 256, 3
    env = tenv.DroneEnv(params=ttypes.default_params(horizon=2),
                        device="cpu")
    launches = traj_cnn_rollout_cuda.launches
    final, planes, stats = traj_cnn_rollout_cuda(
        env.init_batch(3, N), model.flat, model.arch, env.params,
        env.statics, T, compute_dtype=BF16)
    assert traj_cnn_rollout_cuda.launches == launches
    _bf16_close(planes, _traj_planes(out[BF16][1]),
                _traj_planes(out["float32"][1]), 1e-2, "K9 planes")
    _bf16_close(final.fstate(), pack_fstate_batch(out[BF16][0]),
                pack_fstate_batch(out["float32"][0]), 1e-3, "K9 final state")
    assert float(stats["episodes"]) == float(out[BF16][2]["episodes"]) >= N


def test_plain_bf16_cnn_update_matches_reference():
    """K10's plain bf16 arm on the planes of the bf16 CNN rollout, at
    weights moved off them (every branch taken)."""
    params, model, out = _cnn_reference()
    planes = _traj_planes(out[BF16][1])
    T, _, N = planes.shape
    advret = _advret(planes)
    model = _cnn_copy(model)
    with torch.no_grad():  # the heads moved off the planes' weights
        w = tcnn.cnn_all_weights(model.flat, model.arch)
        g = torch.Generator().manual_seed(5)
        for t, scale in ((w[6][0], 0.05), (w[7][0], 2.0), (w[7][1], 2.0)):
            t += scale * torch.randn(t.shape, generator=g)
        w[8].add_(0.1)
    moved = tcnn.params_to_flax(model)
    co = PU.UpdateConsts(clip_eps=0.2, vf_clip=0.5, vf_coef=0.5,
                         inv_m=1.0 / (N * T))
    perm = np.array([1, 0], np.int32)
    tensors = PCP.cnn_kernel_tensors(moved, GEOM)
    gx, gy = jpixels.patch_grid(8, 2)
    want = {}
    for cd in ("float32", BF16):
        g_list, st = PUC.ppo_cnn_update(
            jnp.asarray(planes.reshape(T, -1, N // 128, 128)),
            jnp.asarray(advret.reshape(2, T, N // 128, 128)),
            jnp.asarray(perm), tensors[:-1], tensors[-1], gx, gy, tc=1,
            geom=GEOM, co=co, rbu=1, mode="reference", compute_dtype=cd)
        want[cd] = np.concatenate(
            [np.asarray(t).reshape(-1) for t in g_list]
            + [np.asarray(st)[PU.ST_DLS0:]]), np.asarray(st)
    launches = ppo_cnn_update_cuda.launches
    grads, stats = ppo_cnn_update_cuda(
        torch.from_numpy(planes), torch.from_numpy(advret),
        torch.from_numpy(perm), model.flat, model.arch,
        cuda_update.UpdateConsts(co.clip_eps, co.vf_clip, co.vf_coef,
                                 co.inv_m), 128, compute_dtype=BF16)
    assert ppo_cnn_update_cuda.launches == launches
    _grads_close(grads, want[BF16][0], want["float32"][0],
                 tcnn.cnn_kernel_order(model.arch), "K10")
    np.testing.assert_allclose(stats.numpy(), want[BF16][1], rtol=GRAD_REL,
                               atol=1e-4 * np.abs(want[BF16][1]).max())


def _reference_perms(jr, cfg, n_rb):
    """The reference megakernel trainer's epoch permutations
    (ppo_pallas.run_epoch_scans) for a runner key."""
    _, kperm = jax.random.split(jr.key)
    return np.stack([np.asarray(jax.random.permutation(k, n_rb))
                     for k in jax.random.split(kperm, cfg.epochs)])


def _step_close(m, jm, params, jparams, mu, jmu, what, metric_rtol=1e-3,
                param_atol=1e-6):
    """One update against the reference's: metrics within metric_rtol /
    atol 1e-5 (the losses' sums of bf16-rounded terms), params within rtol
    1e-4 / param_atol, the first moments within MOMENT_REL of their max."""
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(np.asarray(m[k]), np.asarray(jm[k]),
                                   rtol=metric_rtol, atol=1e-5,
                                   err_msg=f"{what} {k}")
    for name, t in params.items():
        np.testing.assert_allclose(t.numpy(), jparams[name], rtol=1e-4,
                                   atol=param_atol, err_msg=f"{what} {name}")
    mu, jmu = np.asarray(mu), np.asarray(jmu)
    np.testing.assert_allclose(mu, jmu, rtol=0,
                               atol=MOMENT_REL * np.abs(jmu).max(),
                               err_msg=f"{what} mu")


def test_bf16_train_step_matches_reference_trainer():
    """One MLP megakernel update under bfloat16 against the reference's
    (make_pallas_train_step(mode="reference", compute_dtype="bfloat16"))
    on the same weights, env state and permutations."""
    hidden = (16, 16)
    jcfg = jppo.PPOConfig(**SMALL)
    jenv = drone_tpu.DroneEnv()
    jr = jppo.init_runner(FlaxActorCritic(hidden=hidden), jenv, jcfg, seed=1)
    jr = jr.replace(opt_state=ppo_pallas.init_fused_opt_state(jr.params))
    jstep = jax.jit(ppo_pallas.make_pallas_train_step(
        jppo.make_optimizer(jcfg), jenv.params, jenv.statics, jcfg,
        mode="reference", fused_optimizer=True, compute_dtype=BF16))
    n_rb = ppo_cuda.plan_minibatch_geometry(PPOConfig(**SMALL), 256)[3]
    perms = _reference_perms(jr, jcfg, n_rb)
    jr2, jm = jstep(jr)

    env = tenv.DroneEnv(device="cpu")
    model = ActorCritic(hidden, dtype=torch.bfloat16)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr.params)))
    runner = init_runner(model, env, PPOConfig(**SMALL), seed=1)
    launches = (traj_rollout_cuda.launches, ppo_update_cuda.launches)
    step = ppo_cuda.make_train_step(env, PPOConfig(**SMALL),
                                    permutations=lambda r: perms,
                                    compute_dtype=BF16)
    r2, m = step(runner)
    assert (traj_rollout_cuda.launches, ppo_update_cuda.launches) == launches
    _, jmu, _ = fused_opt_state_from_flax(jr2.opt_state)
    _step_close(m, jm, r2.params.state_dict(), params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr2.params)), r2.opt_state[1],
        jmu, "MLP")


def test_bf16_cnn_train_step_matches_reference_trainer():
    """One CNN megakernel update under bfloat16 against the reference's
    (make_pallas_cnn_train_step(mode="reference", compute_dtype=
    "bfloat16"); its last value from the plane-space forward, bf16)."""
    cfg = dict(SMALL, horizon=4)
    jcfg = jppo.PPOConfig(**cfg)
    jenv = drone_tpu.DroneEnv()
    jr = jppo.init_runner(FlaxCNN(**CNN_SMALL), jenv, jcfg, seed=1)
    jr = jr.replace(opt_state=PCP.init_fused_opt_state(jr.params, GEOM))
    jstep = jax.jit(PCP.make_pallas_cnn_train_step(
        jppo.make_optimizer(jcfg), jenv.params, jenv.statics, jcfg,
        geom=GEOM, mode="reference", fused_optimizer=True,
        compute_dtype=BF16))
    n_rb = ppo_cuda.plan_minibatch_geometry(PPOConfig(**cfg), 256)[3]
    perms = _reference_perms(jr, jcfg, n_rb)
    jr2, jm = jstep(jr)

    env = tenv.DroneEnv(device="cpu")
    model = PatchCNNActorCritic(**CNN_SMALL)
    model.load_state_dict(tcnn.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr.params)))
    runner = init_runner(model, env, PPOConfig(**cfg), seed=1)
    step = ppo_cnn_cuda.make_cnn_train_step(env, PPOConfig(**cfg),
                                            permutations=lambda r: perms,
                                            compute_dtype=BF16)
    r2, m = step(runner)
    _, jmu, _ = fused_opt_state_from_flax(jr2.opt_state)
    _step_close(m, jm, r2.params.state_dict(), tcnn.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr2.params)), r2.opt_state[1],
        jmu, "CNN")


def test_bf16_module_matches_flax():
    """ActorCritic(dtype=bfloat16), the scan tier's bf16 policy, against
    flax's ActorCritic(dtype=bfloat16) on the same weights and numpy
    observations: every activation rounded to bf16 at the same places, so
    the outputs agree to a few bf16 flips, and much closer than to flax's
    float32 module."""
    hidden = (32, 32)
    obs = np.random.default_rng(4).normal(size=(2048, 13)).astype(np.float32)
    fm = FlaxActorCritic(hidden=hidden)
    params = jax.tree_util.tree_map(np.asarray, fm.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 13))))
    model = ActorCritic(hidden, dtype=torch.bfloat16)
    model.load_state_dict(params_from_flax(params))
    with torch.no_grad():
        mean, _, value = model(torch.from_numpy(obs))
    got = np.concatenate([mean.numpy(), value.numpy()[:, None]], 1)
    want = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jm, _, jv = FlaxActorCritic(hidden=hidden, dtype=dt).apply(params, obs)
        want[dt] = np.concatenate([np.asarray(jm, np.float32),
                                   np.asarray(jv, np.float32)[:, None]], 1)
    _bf16_close(got, want[jnp.bfloat16], want[jnp.float32], 2e-2,
                "ActorCritic(dtype=bfloat16)")


def test_bf16_scan_step_matches_reference():
    """One scan-trainer update of ActorCritic(dtype=bfloat16) against the
    reference's scan trainer over flax's bf16 ActorCritic, with the
    reference's own draws (tests/test_torch_scan.py reference_draws). Every
    activation and gradient of the module is bf16 on both sides, rounded at
    other places by autograd and by JAX: the parameters are held within
    5e-4 (Adam moves each by up to lr a step, 3e-4, whatever the
    gradient's precision; measured 1.1e-4), the metrics within rtol 2e-3
    (measured 8e-4)."""
    from tests.test_torch_scan import reference_draws

    hidden = (16, 16)
    jcfg = jppo.PPOConfig(**SMALL)
    jenv = drone_tpu.DroneEnv()
    fmodel = FlaxActorCritic(hidden=hidden, dtype=jnp.bfloat16)
    jr = jax.jit(lambda: jppo.init_runner(fmodel, jenv, jcfg, seed=1))()
    jstep = jax.jit(jppo.make_train_step(
        fmodel.apply, jppo.make_optimizer(jcfg), jenv.params, jenv.statics,
        jcfg, rollout="scan"))
    noise, perms = reference_draws(jr.key, jcfg, jcfg.num_envs)
    jr2, jm = jstep(jr)

    cfg = ppo.PPOConfig(**SMALL)
    env = tenv.DroneEnv(device="cpu")
    model = ActorCritic(hidden, dtype=torch.bfloat16)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr.params)))
    runner = ppo.init_runner(model, env, cfg, seed=1)
    r2, m = ppo.make_train_step(model, env, cfg,
                                permutations=lambda r: perms,
                                noise=lambda r: torch.from_numpy(noise))(runner)
    jmu = fused_opt_state_from_flax(
        ppo_pallas.optax_to_fused_opt_state(jr2.opt_state))[1]
    _step_close(m, jm, r2.params.state_dict(), params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr2.params)), r2.opt_state[1],
        jmu, "scan", metric_rtol=2e-3, param_atol=5e-4)
