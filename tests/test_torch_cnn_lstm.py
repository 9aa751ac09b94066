"""The pixel-recurrent family (run.policy=cnn_lstm): the CNN-encoder arms of
K8, K6 and K7, their module and trainer, plain versions against drone_tpu's.

`CNNLSTMActorCritic` and `PatchCNNEncoder` are held to the flax modules'
`apply` on weights carried across by `params_from_flax`, within rtol 1e-5
(torch and XLA round exp, sigmoid and the sums differently by an ulp or
so). The plain versions of K8's and K6's CNN arm (the recurrent acting
wrappers on CPU tensors) are held to `traj_lstm_rollout_reference` on the
same env state and weights: carries, planes and anchors within rtol 1e-5 /
atol 2e-6 over 3 steps, episode statistics over more. The plain K7 arm is
held to `ppo_lstm_update(mode="reference", encoder="cnn")` and to
torch.autograd of the segmented PPO loss through the module, each gradient
tensor within 1e-4 x its max |value| (the sums run in another order). One
update of `make_rnn_train_step` is held to `make_pallas_rnn_train_step(
mode="reference", fused_optimizer=True)` under the reference's own
permutations. The reference's small test geometry (res 8, 2x2 patches,
channels (8, 8), trunk 16, hidden 16) keeps them fast; the entry points
build the default tower, which the kernels take, and run it on a few lanes.

The kernels themselves run only on the card (chip_smoke.py); here the
layouts they read are checked against the flat buffer, and evaluate()'s
and build()'s routing by the kernels' envelope checks (F5).
"""

import functools
import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import drone_tpu
from drone_tpu import ppo as jppo
from drone_tpu import ppo_pallas
from drone_tpu import ppo_rnn as jrnn
from drone_tpu import ppo_rnn_pallas as PRP
from drone_tpu.models import CNNLSTMActorCritic as FlaxCNNLSTM
from drone_tpu.models import PatchCNNEncoder as FlaxEncoder
from drone_tpu.ops import pallas_acting_lstm as PAL
from drone_tpu.ops import pallas_acting_traj as PAT
from drone_tpu.ops import pallas_update as PU
from drone_tpu.ops import pallas_update_lstm as PUL
from drone_tpu_torch import cli, ppo_cuda, ppo_rnn_cuda, train
from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import (
    CNNLSTMActorCritic,
    CnnArch,
    PatchCNNEncoder,
    fused_opt_state_from_flax,
    lstm_kernel_offsets,
    lstm_kernel_order,
)
from drone_tpu_torch.models.cnn import params_from_flax as cnn_from_flax
from drone_tpu_torch.models.lstm import (
    fused_opt_state_to_flax,
    params_from_flax,
    params_to_flax,
)
from drone_tpu_torch.ops import (
    cuda_acting_lstm,
    cuda_update,
    cuda_update_lstm,
    lstm_act_rollout_cuda,
    lstm_update_cuda,
    traj_lstm_rollout_cuda,
)
from drone_tpu_torch.ops.cuda_acting_cnn import KERNEL_ARCH
from drone_tpu_torch.ppo import PPOConfig
from drone_tpu_torch.ppo_rnn import init_recurrent_runner
from drone_tpu_torch.types import default_params
from drone_tpu_torch.utils.checkpoint import Checkpointer
from drone_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
HOVER = ROOT / "configs" / "hover.toml"
SMALL = dict(res=8, patch0=2, patch1=2, channels=(8, 8), trunk_hidden=16,
             hidden=16)
H, ARCH = 16, CnnArch(8, 2, 2, 8, 8, 16)
N, T, BPTT = 256, 8, 4


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_model(kw):
    return CNNLSTMActorCritic(kw.get("hidden", 128), kw.get("res", 24),
                              kw.get("patch0", 4), kw.get("patch1", 2),
                              kw.get("channels", (64, 64)),
                              kw.get("trunk_hidden", 128))


@functools.lru_cache(maxsize=None)
def _flax(kw_items=tuple(SMALL.items()), seed=0):
    fm = FlaxCNNLSTM(**dict(kw_items))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(fm.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 13)), fm.initial_carry((1,))))
    return fm, params


def _weights(kw=SMALL, seed=0):
    """The same weights in both packages: (flax module, params, port
    module made anew per call, as tests move it)."""
    fm, params = _flax(tuple(kw.items()), seed)
    model = _port_model(kw)
    model.load_state_dict(params_from_flax(params))
    return fm, params, model


def _close(a, b, err="", rtol=1e-5, atol=2e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=err)


def _close_to_max(got, want, err=""):
    """Within 1e-4 of the reference tensor's largest |value|."""
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) + 1e-12
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=1e-4 * scale, err_msg=err)


@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "defaults"])
def test_module_matches_flax(kw):
    fm, params, model = _weights(kw)
    hidden = kw.get("hidden", 128)
    rng = np.random.default_rng(0)
    n = 64 if kw else 8
    obs = rng.normal(size=(n, 13)).astype(np.float32)
    c, h = (rng.normal(scale=0.5, size=(n, hidden)).astype(np.float32)
            for _ in range(2))
    mean, log_std, value, (c2, h2) = jax.jit(fm.apply)(params, obs, (c, h))
    got = model(torch.from_numpy(obs), (torch.from_numpy(c),
                                        torch.from_numpy(h)))
    for name, a, b in (("mean", got[0], mean), ("log_std", got[1], log_std),
                       ("value", got[2], value), ("c", got[3][0], c2),
                       ("h", got[3][1], h2)):
        _close(a.detach(), b, name, atol=1e-6)


def test_patch_cnn_encoder_matches_flax():
    enc = FlaxEncoder(res=8, patch0=2, patch1=2, channels=(8, 8), hidden=16)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(enc.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 13))))
    model = PatchCNNEncoder(8, 2, 2, (8, 8), 16)
    sd = cnn_from_flax({**params["params"], "log_std": np.zeros(4),
                        "actor_mean": {"kernel": np.zeros((16, 4)),
                                       "bias": np.zeros(4)},
                        "critic_value": {"kernel": np.zeros((16, 1)),
                                         "bias": np.zeros(1)}})
    model.load_state_dict({k: v for k, v in sd.items()
                           if k.split(".")[0] in ("conv0", "conv1", "trunk")})
    obs = np.random.default_rng(2).normal(size=(32, 13)).astype(np.float32)
    _close(model(torch.from_numpy(obs)).detach(),
           jax.jit(enc.apply)(params, obs), atol=1e-6)


def test_converters_round_trip_and_flat_layout():
    """params_to_flax inverts params_from_flax bit for bit; the flat buffer
    holds the reference's lstm_kernel_tensors in order (23 tensors, 226,697
    floats at the defaults) and the fused optimizer state converts both
    ways."""
    _, params, model = _weights()
    back = params_to_flax(model)
    flat_a, tree_a = jax.tree_util.tree_flatten(back)
    flat_b, tree_b = jax.tree_util.tree_flatten(params)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    tensors, n_enc = PRP.lstm_kernel_tensors(params)
    flat = model.flatten_()
    assert n_enc == 3 and len(tensors) == len(model.kernel_order()) == 23
    np.testing.assert_array_equal(flat.numpy(), np.concatenate(
        [np.asarray(t).reshape(-1) for t in tensors]))
    assert lstm_kernel_offsets(128, KERNEL_ARCH)[1] == 226697
    rng = np.random.default_rng(0)
    mu = [rng.normal(size=np.shape(t)).astype(np.float32) for t in tensors]
    nu = [rng.uniform(size=np.shape(t)).astype(np.float32) for t in tensors]
    state = fused_opt_state_from_flax((np.float32(9.0), mu, nu))
    c2, mu2, nu2 = fused_opt_state_to_flax(state, H, ARCH)
    assert float(c2) == 9.0
    for a, b in zip(mu + nu, mu2 + nu2):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _jax_env(horizon):
    env = drone_tpu.DroneEnv()
    return env, env.params.replace(horizon=jnp.int32(horizon))


@pytest.mark.parametrize("T_,stochastic", [(3, False), (3, True),
                                           (12, False)])
def test_plain_k6_k8_cnn_arm_match_reference(T_, stochastic):
    """K6's plain CNN arm against traj_lstm_rollout_reference (planes,
    anchors, final carry) and K8's (deterministic) against the same
    reference's final carry and episode statistics, from a random carry:
    to a tolerance over 3 steps, statistically over 12 (episodes of 6)."""
    fm, params, model = _weights()
    n = 256
    env, p = _jax_env(6)
    rng = np.random.default_rng(1)
    carry = tuple(rng.normal(scale=0.5, size=(n, H)).astype(np.float32)
                  for _ in range(2))
    bptt = 1 if T_ == 3 else 4
    _, want_carry, traj, snap, want = PAL.traj_lstm_rollout_reference(
        env.init_batch(3, n), params, carry, p, env.statics, T_, bptt=bptt,
        stochastic=stochastic, seg_layout="planes")
    tenv_ = tenv.DroneEnv(params=default_params("hover", horizon=6),
                          device="cpu")
    tcarry = tuple(torch.from_numpy(c) for c in carry)
    launches = (traj_lstm_rollout_cuda.launches,
                lstm_act_rollout_cuda.launches)
    _, got_carry, planes, anchors, got = traj_lstm_rollout_cuda(
        tenv_.init_batch(3, n), model.flatten_(), (H, ARCH), tcarry,
        tenv_.params, tenv_.statics, T_, bptt, stochastic)
    if T_ == 3:
        want_planes = np.asarray(PAT.pack_traj_planes(traj, n // 128))
        _close(planes, want_planes.reshape(T_, -1, n), "planes")
        _close(anchors, snap, "anchors")
        for a, b in zip(got_carry, want_carry):
            _close(a, b, "carry")
    assert float(got["episodes"]) == float(want["episodes"])
    if stochastic:
        return
    _, k8_carry, k8 = lstm_act_rollout_cuda(
        tenv_.init_batch(3, n), model.flat, (H, ARCH), tcarry, tenv_.params,
        tenv_.statics, T_)
    assert (traj_lstm_rollout_cuda.launches,
            lstm_act_rollout_cuda.launches) == launches  # CPU: no kernel
    assert float(k8["episodes"]) == float(want["episodes"])
    assert T_ == 3 or float(k8["episodes"]) >= n
    for k in ("reward_sum", "ep_return_sum", "ep_length_sum"):
        _close(float(k8[k]), float(want[k]), k, rtol=1e-4)
    if T_ == 3:
        for a, b in zip(k8_carry, want_carry):
            _close(a, b, "K8 carry")


def test_lstm_value_takes_the_cnn_encoder():
    _, params, model = _weights()
    rng = np.random.default_rng(4)
    obs = rng.normal(size=(64, 13)).astype(np.float32)
    carry = tuple(rng.normal(scale=0.5, size=(64, H)).astype(np.float32)
                  for _ in range(2))
    want = PRP._lstm_value(obs, carry, params)
    got = cuda_acting_lstm.lstm_value(
        torch.from_numpy(obs), tuple(torch.from_numpy(c) for c in carry),
        model.flatten_(), H, ARCH)
    _close(got, want, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _reference(seed):
    """A reference CNN-LSTM rollout's planes and anchors (episodes of 6
    steps, so resets fall inside the segments) and their normalized
    advantages."""
    fm, params = _flax(tuple(SMALL.items()), seed)
    env, p = _jax_env(6)
    final, carry, traj, snap, _ = PAL.traj_lstm_rollout_reference(
        env.init_batch(3, N), params, fm.initial_carry((N,)), p, env.statics,
        T, bptt=BPTT, seg_layout="planes")
    rows = N // 128
    planes = PAT.pack_traj_planes(traj, rows)
    last_value = PRP._lstm_value(env.observe_batch(final), carry,
                                 params).reshape(rows, 128)
    advret = ppo_pallas.normalized_advret(planes, last_value,
                                          jppo.PPOConfig(), None)
    seg_batch = (snap[:, 0].transpose(0, 2, 1), snap[:, 1].transpose(0, 2, 1))
    return (np.asarray(planes), np.asarray(advret), np.asarray(snap), traj,
            seg_batch)


def _co():
    # a narrow value clip, so that moved weights take its branches
    return cuda_update.UpdateConsts(0.2, 0.2, 0.5, 1.0 / (N * T))


def _port_args(model, perm, co):
    planes, advret, snap, *_ = _reference(0)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    model.flatten_()
    return (t(planes).reshape(T, -1, N), t(advret).reshape(2, T, N), t(snap),
            torch.from_numpy(np.asarray(perm, np.int32)), model.flat,
            (H, ARCH), co, 128, BPTT)


@functools.lru_cache(maxsize=None)
def _reference_update():
    """ppo_lstm_update(mode="reference") of the CNN arm on _reference(0)'s
    minibatch [1, 0] at vf_clip 0.2, jitted once over the weights."""
    planes, advret, snap, *_ = _reference(0)
    co = _co()
    return jax.jit(lambda tensors: PUL.ppo_lstm_update(
        jnp.asarray(planes), jnp.asarray(advret), jnp.asarray(snap),
        jnp.array([1, 0], jnp.int32), tensors[:-1], tensors[-1], bptt=BPTT,
        co=PU.UpdateConsts(clip_eps=co.clip_eps, vf_clip=co.vf_clip,
                           vf_coef=co.vf_coef, inv_m=co.inv_m),
        rbu=1, sc=2, mode="reference", encoder="cnn", geom=ARCH.geom))


def _against_reference(params, model, ent_coef=0.0):
    tensors, _ = PRP.lstm_kernel_tensors(params)
    want, st = _reference_update()([jnp.asarray(t) for t in tensors])
    co, perm = _co(), [1, 0]
    launches = lstm_update_cuda.launches
    grads, stats = lstm_update_cuda(*_port_args(model, perm, co),
                                    ent_coef=ent_coef)
    assert lstm_update_cuda.launches == launches  # CPU tensors: no kernel
    offs, _ = lstm_kernel_offsets(H, ARCH)
    order = lstm_kernel_order(H, ARCH)
    for (name, shape), w in zip(order, want):
        got = grads[offs[name]:offs[name] + int(np.prod(shape))]
        _close_to_max(got.numpy(), np.asarray(w).reshape(-1), name)
    _close_to_max(stats.numpy(), np.asarray(st), "stats")
    ls = offs["log_std"]
    _close(grads[ls:], np.asarray(st)[PU.ST_DLS0:] - ent_coef)
    return stats


def test_plain_k7_cnn_arm_matches_reference():
    _, params, model = _weights()
    _against_reference(params, model, ent_coef=0.01)


def test_plain_k7_cnn_arm_matches_reference_off_policy():
    """At weights moved off the planes' every branch of the head's
    subgradients is taken, and the approx-KL and clip-fraction sums are
    nonzero."""
    _, _, model = _weights()
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for p, scale in ((model.actor_mean.weight, 0.1),
                         (model.actor_mean.bias, 0.1),
                         (model.critic_value.weight, 2.0),
                         (model.critic_value.bias, 2.0)):
            p += torch.from_numpy(
                (scale * rng.normal(size=tuple(p.shape))).astype(np.float32))
        model.log_std += 0.1
    n = cuda_update_lstm.lstm_head_branch_counts(*_port_args(model, [1, 0],
                                                             _co()))
    assert n["ratio_out"] > n["policy_grad_zero"] > 0, n
    assert n["value_out"] > n["value_grad_zero"] > 0, n
    params = jax.tree_util.tree_map(jnp.asarray, params_to_flax(model))
    stats = _against_reference(params, model)
    assert float(stats[cuda_update.ST_KL]) != 0.0
    assert float(stats[cuda_update.ST_CF]) > 0.0


def test_plain_k7_cnn_arm_matches_autograd():
    """The hand-written conv + BPTT backward against torch.autograd of the
    segmented PPO loss through the module (its image path): truncation at
    the segment anchors, done-masked carries, the log_std gradient with its
    entropy term."""
    _, _, model = _weights()
    ent_coef, co = 0.01, _co()
    args = _port_args(model, [0, 1], co)
    grads, _ = lstm_update_cuda(*args, ent_coef=ent_coef)
    planes, advret, snap = args[:3]
    obs = planes[:, :13].permute(0, 2, 1)
    act, logp_old, v_old = (planes[:, 13:17].permute(0, 2, 1), planes[:, 17],
                            planes[:, 18])
    keep = 1.0 - planes[:, 20]
    adv, ret = advret[0], advret[1]
    loss = 0.0
    for s in range(T // BPTT):
        c, h = snap[s, 0].t(), snap[s, 1].t()
        for t in range(s * BPTT, (s + 1) * BPTT):
            mean, log_std, value, (c, h) = model(obs[t], (c, h))
            lp = (-0.5 * ((act[t] - mean) / torch.exp(log_std)) ** 2
                  - log_std - 0.5 * np.log(2 * np.pi)).sum(1)
            ratio = torch.exp(lp - logp_old[t])
            pg = torch.maximum(-adv[t] * ratio,
                               -adv[t] * torch.clamp(ratio, 0.8, 1.2))
            vc = v_old[t] + torch.clamp(value - v_old[t], -0.2, 0.2)
            vl = 0.5 * torch.maximum((value - ret[t]) ** 2,
                                     (vc - ret[t]) ** 2)
            loss = loss + (pg + 0.5 * vl).sum()
            c, h = c * keep[t][:, None], h * keep[t][:, None]
    ent = (model.log_std + 0.5 * np.log(2 * np.pi * np.e)).sum()
    (loss / (N * T) - ent_coef * ent).backward()
    offs, _ = lstm_kernel_offsets(H, ARCH)
    sd = dict(model.named_parameters())
    for name, shape in lstm_kernel_order(H, ARCH):
        got = grads[offs[name]:offs[name] + int(np.prod(shape))]
        _close_to_max(got.numpy(), sd[name].grad.reshape(-1).numpy(), name)


def test_net_layout_and_envelope_of_the_cnn_arm():
    """The layout of the CNN arm: no dense layer, the heads at their flat
    offsets; the LSTM's input rows are the trunk's 128; the CNN arm's
    blocks fit an H100's shared memory; only the default tower and a hidden
    <= 128 (a multiple of 4) go to the kernels."""
    ints = cuda_acting_lstm.net_layout(128, KERNEL_ARCH)
    offs, _ = lstm_kernel_offsets(128, KERNEL_ARCH)
    M = cuda_acting_lstm.MAX_ENC
    assert list(ints[:2]) == [0, 128] and not ints[2:2 + 2 * M].any()
    assert list(ints[2 + 2 * M:]) == [offs["actor_mean.weight"],
                                      offs["critic_value.weight"],
                                      offs["log_std"]]
    assert offs["lstm.ii.weight"] == offs["trunk.bias"] + 128 == 94464
    assert cuda_acting_lstm.act_smem_bytes(128, KERNEL_ARCH) == 185408
    assert cuda_update_lstm.bptt_smem_bytes(128, KERNEL_ARCH) == 186048
    cuda_update_lstm.check_envelope(128, KERNEL_ARCH)
    for hidden, arch in ((256, KERNEL_ARCH), (30, KERNEL_ARCH), (16, ARCH)):
        with pytest.raises(ValueError):
            cuda_update_lstm.check_envelope(hidden, arch)
        with pytest.raises(ValueError):
            cuda_acting_lstm.check_act_envelope(hidden, arch)


def test_grad_products_of_the_cnn_arm_cover_the_flat_buffer():
    """K7's CNN arm: the conv backward's block rows hold W0, b0, W1, b1 in
    the flat order, then the trunk's product (dzt x X2, bias beside it), the
    gates' and the heads'; every parameter but log_std reads one entry."""
    pairs, ptot, mp = cuda_update_lstm.grad_products(128, KERNEL_ARCH)
    offs, P = lstm_kernel_offsets(128, KERNEL_ARCH)
    used = mp[mp >= 0]
    assert len(used) == P - 4 and len(set(used.tolist())) == len(used)
    n_conv = offs["trunk.weight"]
    assert n_conv == 20608 and (mp[:n_conv] == np.arange(n_conv)).all()
    U = cuda_update_lstm
    assert list(pairs[0]) == [U.DP, 0, 128, U.X2S, 0, 576, n_conv]
    assert list(pairs[1][:6]) == [U.GZ, 0, 512, U.XS, 13, 256]
    assert mp[offs["trunk.bias"] + 5] == n_conv + 5 * 577 + 576
    assert n_conv + int(pairs[:, 2].dot(pairs[:, 5] + 1)) == ptot
    # GF: the gate block's six quantities over its 128 units
    assert U.scratch_rows(128, KERNEL_ARCH) == [269, 512, 6 * 128, 128, 5,
                                                128, 576]


def test_cnn_arm_kernels_refuse_cpu_tensors():
    model = _port_model({})
    env = tenv.DroneEnv(device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_acting_lstm.lstm_act_rollout_kernel(
            env.init_batch(0, 64), model.flatten_(), (128, KERNEL_ARCH),
            model.initial_carry(64), env.params, env.statics, 2)


SMALL_CFG = dict(horizon=T, num_envs=N, epochs=2, num_minibatches=2,
                 bptt_horizon=BPTT, anneal_lr=True, total_updates=10)


def test_train_step_matches_reference_trainer():
    jcfg = jppo.PPOConfig(**SMALL_CFG)
    jenv = drone_tpu.DroneEnv()
    fm = FlaxCNNLSTM(**SMALL)
    jr = jrnn.init_recurrent_runner(fm, jenv, jcfg, seed=1)
    jr = jr.replace(opt_state=PRP.init_fused_opt_state(jr.params))
    jstep = jax.jit(PRP.make_pallas_rnn_train_step(
        jppo.make_optimizer(jcfg), jenv.params, jenv.statics, jcfg,
        mode="reference", fused_optimizer=True))
    _, kperm = jax.random.split(jr.key)
    n_rb = ppo_cuda.plan_minibatch_geometry(PPOConfig(**SMALL_CFG), N)[3]
    perms = np.stack([np.asarray(jax.random.permutation(k, n_rb))
                      for k in jax.random.split(kperm, jcfg.epochs)])
    jr2, jm = jstep(jr)

    env = tenv.DroneEnv(device="cpu")
    model = _port_model(SMALL)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr.params)))
    runner = init_recurrent_runner(model, env, PPOConfig(**SMALL_CFG), seed=1)
    step = ppo_rnn_cuda.make_rnn_train_step(env, PPOConfig(**SMALL_CFG),
                                            permutations=lambda r: perms)
    r2, m = step(runner)

    close = functools.partial(_close, rtol=1e-4, atol=1e-6)
    assert set(m) == set(jm) == set(ppo_cuda.METRIC_KEYS)
    for k in jm:
        close(m[k], jm[k], k)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jr2.params))
    for name, t in r2.params.state_dict().items():
        close(t, want[name], name)
    count, mu, nu = fused_opt_state_to_flax(r2.opt_state, H, ARCH)
    jcount, jmu, jnu = jr2.opt_state
    assert float(count) == float(jcount) == 4.0
    for i, (a, b) in enumerate(zip(mu + nu, list(jmu) + list(jnu))):
        close(a, b, f"moment {i}")
    for a, b in zip(r2.carry, jr2.carry):
        close(a, b, "carry")


CNN_LSTM = ["run.policy=cnn_lstm", "run.lstm_hidden=16"]


def _cfg(tmp_path, name, total, extra=()):
    return Config.default().with_overrides([
        *CNN_LSTM, "train.num_envs=256", "train.horizon=8",
        "train.bptt_horizon=4", "train.epochs=2", "train.num_minibatches=2",
        "run.log_interval=1", "run.checkpoint_interval=100",
        f"run.total_updates={total}", f"run.run_name={name}",
        f"run.checkpoint_dir={tmp_path}", *extra])


def test_cnn_lstm_resume_is_bitwise(tmp_path):
    """train(3) == train(2) + resume(1) with run.policy=cnn_lstm on the CPU:
    every tensor of the runner, the LSTM carry included."""
    full, _ = train.train(_cfg(tmp_path, "full", 3), device="cpu")
    train.train(_cfg(tmp_path, "half", 2), device="cpu")
    ckpt = tmp_path / "half" / "checkpoints"
    resumed, last = train.train(
        _cfg(tmp_path, "resumed", 3, [f"run.resume_from={ckpt}"]),
        device="cpu")
    assert "conv0.weight" in resumed.params.state_dict()
    assert resumed.params.flat.numel() == lstm_kernel_offsets(
        16, KERNEL_ARCH)[1]

    def tensors(r):
        return [*r.params.state_dict().values(), *r.opt_state,
                r.env_state.fstate(), r.env_state.step, *r.carry,
                r.generator.get_state()]

    for a, b in zip(tensors(full), tensors(resumed)):
        assert torch.equal(a, b)
    assert np.isfinite(last["loss"])


def test_cli_train_then_eval_cnn_lstm_on_cpu(tmp_path, capsys):
    over = ["--device", "cpu", *CNN_LSTM]
    assert cli.main(["train", str(HOVER), *over, f"train.num_envs={N}",
                     "train.horizon=8", "train.bptt_horizon=4",
                     "train.num_minibatches=2", "train.epochs=1",
                     "run.total_updates=2", f"run.checkpoint_dir={tmp_path}",
                     "run.run_name=cli"]) == 0
    capsys.readouterr()
    launches = lstm_act_rollout_cuda.launches
    assert cli.main(["eval", str(HOVER), *over,
                     f"run.resume_from={tmp_path}/cli/checkpoints",
                     "env.params.horizon=10"]) == 0
    assert lstm_act_rollout_cuda.launches == launches
    assert '"episodes"' in capsys.readouterr().out


@pytest.mark.parametrize("policy,override", [
    ("mlp", "run.hidden=256,256"),
    ("lstm", "run.lstm_hidden=256"),
    ("cnn_lstm", "run.lstm_hidden=256"),
])
def test_evaluate_routes_what_the_kernel_cannot_take_to_the_module(
        monkeypatch, policy, override):
    """F5: a deterministic policy past its acting kernel's envelope (K5's
    shared memory, K8's hidden <= 128) is served through the module, as
    the reference serves it; the wrapper is never called."""
    cfg = Config.from_toml(HOVER).with_overrides([
        f"run.policy={policy}", override, "env.params.horizon=3"])
    _, model = train.build_env_and_model(cfg, device="cpu")

    def refuse(*a, **k):
        raise AssertionError("the acting kernel's wrapper was called")

    monkeypatch.setattr(train, "act_rollout_cuda", refuse)
    monkeypatch.setattr(train, "lstm_act_rollout_cuda", refuse)
    stats = train.evaluate(cfg, runner=types.SimpleNamespace(params=model),
                           episodes=16, device="cpu")
    assert stats["episodes"] == 16 and np.isfinite(stats["ep_return_mean"])
