"""K3 (PPO update) and K4 (fused clip+adam): plain versions against
drone_tpu's.

`ppo_update_cuda` and `fused_adam_cuda` run their plain PyTorch versions on
CPU tensors. K3's is held to `pallas_update.ppo_update(mode="reference")`
on the same planes, advantages and a strided row-block permutation, and to
torch.autograd of the same plane-space loss, the gradients at rtol 2e-4 /
atol 1e-7 (the sums run in another order; the reference pins its own
backprop to jax.grad at the same tolerance), the stat sums at rtol 2e-4 /
atol 2e-6. K4's is held to `fused_adam(mode=
"reference")` at rtol 1e-5 / atol 1e-8 with a nonzero step count and the
norm clip active. `normalized_advret` (GAE + normalization) is held to the
reference's at rtol 1e-5.

The kernels themselves run only on the card (chip_smoke.py); here the
layout ints they take are checked against the flat buffer.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import drone_tpu
from drone_tpu import ppo as jppo
from drone_tpu import ppo_pallas
from drone_tpu.models import ActorCritic as FlaxActorCritic
from drone_tpu.ops import pallas_acting_traj as PAT
from drone_tpu.ops import pallas_update as PU
from drone_tpu.ops.pallas_acting import actor_weights
from drone_tpu_torch import ppo_cuda
from drone_tpu_torch.models import (
    ActorCritic,
    kernel_offsets,
    kernel_order,
    params_from_flax,
    params_to_flax,
    tensor_sizes,
)
from drone_tpu_torch.ops import cuda_update, fused_adam_cuda, ppo_update_cuda
from drone_tpu_torch.ppo import PPOConfig

HIDDEN = (16, 16)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(T=8, rows=8, seed=0):
    """Planes of a real reference rollout, random advantages, and the same
    weights in both packages."""
    env = drone_tpu.DroneEnv()
    params = FlaxActorCritic(hidden=HIDDEN).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 13), jnp.float32))
    _, planes, _ = PAT.traj_act_rollout_pallas_planes(
        env.init_batch(seed + 1, rows * 128), params, env.params, env.statics,
        T, lanes_per_block=rows * 128, interpret=True)
    planes = np.array(planes)
    adv = np.random.default_rng(seed + 2).normal(
        size=(T, rows, 128)).astype(np.float32)
    ret = planes[:, PAT.TP_VAL] + np.float32(0.5) * adv
    advret = np.stack([adv, ret])
    co = PU.UpdateConsts(clip_eps=0.2, vf_clip=10.0, vf_coef=0.5,
                         inv_m=1.0 / (rows * 128 * T))
    model = ActorCritic(HIDDEN)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    model.flatten_()
    return params, planes, advret, co, model


def _port_consts(co):
    return cuda_update.UpdateConsts(clip_eps=co.clip_eps, vf_clip=co.vf_clip,
                                    vf_coef=co.vf_coef, inv_m=co.inv_m)


def _flat_np(planes):
    T, P, rows, L = planes.shape
    return torch.from_numpy(np.array(planes.reshape(T, P, rows * L)))


def _reference_flat_grads(ga, gc, st):
    parts = [np.asarray(t).reshape(-1) for wb in (*ga, *gc) for t in wb]
    parts.append(np.asarray(st)[PU.ST_DLS0:PU.ST_DLS0 + 4])
    return np.concatenate(parts)


def test_plain_update_matches_reference():
    params, planes, advret, co, model = _fixture()
    perm = np.array([5, 2, 7, 0], np.int32)  # a strided minibatch
    (ga, gc), st = PU.ppo_update(
        jnp.asarray(planes), jnp.asarray(advret), jnp.asarray(perm),
        actor_weights(params), PAT.critic_weights(params),
        PAT._log_std(params), tc=4, co=co, mode="reference")
    launches = ppo_update_cuda.launches
    grads, stats = ppo_update_cuda(
        _flat_np(planes), _flat_np(advret), torch.from_numpy(perm),
        model.flat, HIDDEN, _port_consts(co), rbl=128)
    assert ppo_update_cuda.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(grads.numpy(), _reference_flat_grads(ga, gc, st),
                               rtol=2e-4, atol=1e-7)
    # the approx-KL sum cancels to ~0 over 2,048 samples whose logp terms
    # each round at ~1e-7, so the stat sums take an absolute floor of 2e-6
    np.testing.assert_allclose(stats.numpy(), np.asarray(st), rtol=2e-4,
                               atol=2e-6)


def _autograd_loss(model, planes, advret, co):
    """Plane-space PPO loss over the whole batch (template: the reference's
    _loss_jnp), differentiated by torch.autograd."""
    T, P, N = planes.shape
    flat = planes.permute(1, 0, 2).reshape(P, T * N)
    X = flat[:13].t()
    a = flat[PAT.TP_ACT0:PAT.TP_ACT0 + 4].t()
    logp_old, v_old = flat[PAT.TP_LOGP], flat[PAT.TP_VAL]
    adv, ret = advret[0].reshape(-1), advret[1].reshape(-1)
    mean, log_std, v = model(X)
    z = (a - mean) / torch.exp(log_std)
    lp = (-0.5 * (z * z) - log_std - PAT._HALF_LOG_2PI).sum(1)
    ratio = torch.exp(lp - logp_old)
    pg = torch.maximum(-adv * ratio,
                       -adv * torch.clamp(ratio, 1 - co.clip_eps,
                                          1 + co.clip_eps))
    v_clipped = v_old + torch.clamp(v - v_old, -co.vf_clip, co.vf_clip)
    vl = torch.maximum((v - ret) ** 2, (v_clipped - ret) ** 2)
    return pg.mean() + co.vf_coef * 0.5 * vl.mean()


def test_plain_update_matches_autograd():
    _, planes, advret, co, model = _fixture(T=4, rows=4)
    rows = planes.shape[2]
    grads, _ = ppo_update_cuda(
        _flat_np(planes), _flat_np(advret),
        torch.arange(rows, dtype=torch.int32), model.flat, HIDDEN,
        _port_consts(co), rbl=128)
    loss = _autograd_loss(model, _flat_np(planes), _flat_np(advret), co)
    auto = torch.autograd.grad(loss, list(model.parameters()))
    offs, _ = kernel_offsets(HIDDEN)
    for (name, p), g in zip(model.named_parameters(), auto):
        got = grads[offs[name]:offs[name] + p.numel()].reshape(p.shape)
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=2e-4,
                                   atol=1e-7, err_msg=name)


def _off_policy(model, co, seed=7):
    """Move the port's model away from the weights that wrote the planes
    (noise on both heads, log_std up by 0.1) and narrow vf_clip, so that
    every subgradient branch of the head is taken. Returns the reference's
    params for the moved model and the narrowed constants."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p, scale in ((model.actor_mean.weight, 0.1),
                         (model.actor_mean.bias, 0.1),
                         (model.critic_value.weight, 0.1),
                         (model.critic_value.bias, 0.1)):
            p += torch.from_numpy(
                (scale * rng.normal(size=tuple(p.shape))).astype(np.float32))
        model.log_std += 0.1
    co = PU.UpdateConsts(clip_eps=co.clip_eps, vf_clip=0.2, vf_coef=co.vf_coef,
                         inv_m=co.inv_m)
    return jax.tree_util.tree_map(jnp.asarray, params_to_flax(model)), co


def _assert_every_branch(planes, advret, perm, model, co):
    n = cuda_update.head_branch_counts(
        _flat_np(planes), _flat_np(advret), torch.from_numpy(perm),
        model.flat, HIDDEN, _port_consts(co), rbl=128)
    assert n["ratio_out"] > n["policy_grad_zero"] > 0, n
    assert n["value_out"] > n["value_grad_zero"] > 0, n


def test_plain_update_matches_reference_off_policy():
    _, planes, advret, co, model = _fixture()
    params, co = _off_policy(model, co)
    perm = np.array([5, 2, 7, 0], np.int32)
    _assert_every_branch(planes, advret, perm, model, co)
    (ga, gc), st = PU.ppo_update(
        jnp.asarray(planes), jnp.asarray(advret), jnp.asarray(perm),
        actor_weights(params), PAT.critic_weights(params),
        PAT._log_std(params), tc=4, co=co, mode="reference")
    grads, stats = ppo_update_cuda(
        _flat_np(planes), _flat_np(advret), torch.from_numpy(perm),
        model.flat, HIDDEN, _port_consts(co), rbl=128)
    assert float(stats[cuda_update.ST_KL]) != 0.0
    assert float(stats[cuda_update.ST_CF]) > 0.0
    np.testing.assert_allclose(grads.numpy(), _reference_flat_grads(ga, gc, st),
                               rtol=2e-4, atol=1e-7)
    np.testing.assert_allclose(stats.numpy(), np.asarray(st), rtol=2e-4,
                               atol=2e-6)


def test_plain_update_matches_autograd_off_policy():
    _, planes, advret, co, model = _fixture(T=4, rows=4)
    _, co = _off_policy(model, co)
    rows = planes.shape[2]
    perm = np.arange(rows, dtype=np.int32)
    _assert_every_branch(planes, advret, perm, model, co)
    grads, _ = ppo_update_cuda(
        _flat_np(planes), _flat_np(advret), torch.from_numpy(perm),
        model.flat, HIDDEN, _port_consts(co), rbl=128)
    loss = _autograd_loss(model, _flat_np(planes), _flat_np(advret), co)
    auto = torch.autograd.grad(loss, list(model.parameters()))
    offs, _ = kernel_offsets(HIDDEN)
    for (name, p), g in zip(model.named_parameters(), auto):
        got = grads[offs[name]:offs[name] + p.numel()].reshape(p.shape)
        np.testing.assert_allclose(got.numpy(), g.numpy(), rtol=2e-4,
                                   atol=1e-7, err_msg=name)


def test_update_log_std_gradient_carries_the_entropy_term():
    _, planes, advret, co, model = _fixture(T=4, rows=2)
    args = (_flat_np(planes), _flat_np(advret),
            torch.tensor([1, 0], dtype=torch.int32), model.flat, HIDDEN,
            _port_consts(co))
    g0, st0 = ppo_update_cuda(*args, rbl=128)
    g1, st1 = ppo_update_cuda(*args, rbl=128, ent_coef=0.25)
    ls = kernel_offsets(HIDDEN)[0]["log_std"]
    assert torch.equal(st0, st1)
    assert torch.equal(g0[:ls], g1[:ls])
    torch.testing.assert_close(g1[ls:], st0[cuda_update.ST_DLS0:] - 0.25)


def test_plain_adam_matches_reference():
    params, *_ , model = _fixture(T=2, rows=1)
    tensors, _, _ = ppo_pallas._kernel_tensors(params)
    rng = np.random.default_rng(3)
    grads = [0.05 * rng.normal(size=t.shape).astype(np.float32)
             for t in tensors]
    mus = [0.01 * rng.normal(size=t.shape).astype(np.float32)
           for t in tensors]
    nus = [0.001 * rng.uniform(size=t.shape).astype(np.float32)
           for t in tensors]
    count = 5.0
    jcfg = jppo.PPOConfig(total_updates=10, epochs=2, num_minibatches=4,
                          anneal_lr=True)
    lr = ppo_pallas.make_fused_lr(jcfg)(jnp.float32(count))
    ac = PU.AdamConsts(clip_norm=0.5)
    gnorm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                          for g in grads))
    assert gnorm > 2 * ac.clip_norm  # the clip is active
    w2, mu2, nu2 = PU.fused_adam([jnp.asarray(g) for g in grads], tensors,
                                 [jnp.asarray(m) for m in mus],
                                 [jnp.asarray(v) for v in nus], lr, count,
                                 ac=ac, mode="reference")

    cat = lambda ts: torch.from_numpy(np.concatenate(  # noqa: E731
        [np.asarray(t, np.float32).reshape(-1) for t in ts]))
    theta, mu, nu = model.flat, cat(mus), cat(nus)
    c = torch.tensor(count)
    pcfg = PPOConfig(total_updates=10, epochs=2, num_minibatches=4,
                     anneal_lr=True)
    launches = fused_adam_cuda.launches
    fused_adam_cuda(theta, cat(grads), mu, nu, c, cuda_update.AdamConsts(),
                    ppo_cuda.make_fused_lr(pcfg),
                    tensor_sizes(kernel_order(HIDDEN)))
    assert fused_adam_cuda.launches == launches
    assert float(c) == count + 1.0
    np.testing.assert_allclose(theta.numpy(), cat(w2).numpy(), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(mu.numpy(), cat(mu2).numpy(), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(nu.numpy(), cat(nu2).numpy(), rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("anneal", [False, True])
def test_lr_schedule_matches_reference(anneal):
    jcfg = jppo.PPOConfig(total_updates=7, epochs=3, num_minibatches=2,
                          lr=1e-3, anneal_lr=anneal)
    pcfg = PPOConfig(total_updates=7, epochs=3, num_minibatches=2, lr=1e-3,
                     anneal_lr=anneal)
    jlr, plr = ppo_pallas.make_fused_lr(jcfg), ppo_cuda.make_fused_lr(pcfg)
    for count in (0.0, 1.0, 20.0, 42.0, 50.0):
        want = np.float32(jlr(jnp.float32(count)))
        got = plr(torch.tensor(count)).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.asarray(want).view(np.uint32))


def test_normalized_advret_matches_reference():
    _, planes, _, _, _ = _fixture(T=8, rows=2)
    last_value = np.random.default_rng(5).normal(
        size=(planes.shape[2], 128)).astype(np.float32)
    jcfg = jppo.PPOConfig(gamma=0.99, gae_lambda=0.95)
    want = np.asarray(ppo_pallas.normalized_advret(
        jnp.asarray(planes), jnp.asarray(last_value), jcfg, None))
    got = ppo_cuda.normalized_advret(
        _flat_np(planes), torch.from_numpy(last_value.reshape(-1)),
        PPOConfig(gamma=0.99, gae_lambda=0.95))
    np.testing.assert_allclose(got.numpy(), want.reshape(got.shape),
                               rtol=1e-5, atol=1e-5)


def test_update_layout_matches_the_flat_buffer():
    offs, total = kernel_offsets((32, 24))
    ints = cuda_update.update_layout((32, 24))
    H = cuda_update.UPD_HIDDEN
    assert list(ints[1:3]) == [32, 24]
    assert list(ints[1 + H:4 + H]) == [offs["actor_h0.weight"],
                                       offs["actor_h1.weight"],
                                       offs["actor_mean.weight"]]
    assert list(ints[2 + 2 * H:5 + 2 * H]) == [offs["critic_h0.weight"],
                                               offs["critic_h1.weight"],
                                               offs["critic_value.weight"]]
    assert ints[3 + 3 * H] == total and ints[4 + 3 * H] == offs["log_std"]
    # biases follow their weights, as the kernel assumes
    assert offs["actor_h1.bias"] == offs["actor_h1.weight"] + 24 * 32
    with pytest.raises(ValueError):
        cuda_update.update_layout((512, 512))


def _family_sizes():
    """The flat buffer's length of each family at the trainers' main shapes:
    MLP [64, 64], LSTM (128, encoder (64,)), patch CNN, CNN-LSTM (128)."""
    from drone_tpu_torch.models import (CNNLSTMActorCritic,
                                        PatchCNNActorCritic,
                                        lstm_kernel_order)
    return {"mlp": sum(tensor_sizes(kernel_order((64, 64)))),
            "lstm": sum(tensor_sizes(lstm_kernel_order(128, (64,)))),
            "cnn": sum(tensor_sizes(PatchCNNActorCritic().kernel_order())),
            "cnn_lstm": sum(tensor_sizes(
                CNNLSTMActorCritic(128).kernel_order()))}


@pytest.mark.parametrize("family", ["mlp", "lstm", "cnn", "cnn_lstm"])
def test_adam_grid_is_fixed_by_the_buffer_length(family):
    """K4's grid and its blocks' slices are a function of P alone (so the
    norm's sums run in one order on any card) and cover [0, P) exactly
    once, in slices of at most ADAM_SLICE floats."""
    P = _family_sizes()[family]
    blocks, slices = cuda_update.adam_blocks(P), cuda_update.adam_slices(P)
    assert slices == cuda_update.adam_slices(P)
    assert blocks == len(slices) <= cuda_update.ADAM_MAX_BLOCKS
    assert slices[0][0] == 0 and slices[-1][1] == P
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    assert all(0 < stop - start <= cuda_update.ADAM_SLICE
               and start % cuda_update.ADAM_SLICE == 0
               for start, stop in slices)
    if family == "mlp":
        assert P == 10441 and blocks == 6
    if family == "cnn_lstm":
        assert P == 226697 and blocks == 111


def test_adam_refuses_a_buffer_past_its_envelope():
    """K4 takes up to ADAM_MAX_P floats: past ADAM_MAX_BLOCKS slices its
    blocks own several each (one each up to 524,288 floats)."""
    one_each = cuda_update.ADAM_MAX_BLOCKS * cuda_update.ADAM_SLICE
    assert cuda_update.adam_blocks(one_each) == cuda_update.ADAM_MAX_BLOCKS
    assert cuda_update.adam_blocks(one_each - 1) == cuda_update.ADAM_MAX_BLOCKS
    assert cuda_update.adam_blocks(one_each + 1) == cuda_update.ADAM_MAX_BLOCKS
    most = cuda_update.ADAM_MAX_P
    assert cuda_update.adam_blocks(most) == cuda_update.ADAM_MAX_BLOCKS
    for P in (0, most + 1):
        with pytest.raises(ValueError, match="K4 takes"):
            cuda_update.adam_blocks(P)
    z = torch.zeros(1).expand(most + 1)
    with pytest.raises(ValueError, match="K4 takes"):
        cuda_update.fused_adam_kernel(z, z, z, z, torch.tensor(0.0),
                                      cuda_update.AdamConsts(),
                                      ppo_cuda.make_fused_lr(PPOConfig()),
                                      [most + 1])


def test_kernels_refuse_cpu_tensors():
    _, planes, advret, co, model = _fixture(T=2, rows=1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_update.ppo_update_kernel(
            _flat_np(planes), _flat_np(advret),
            torch.zeros(1, dtype=torch.int32), model.flat, HIDDEN,
            _port_consts(co), rbl=128)
    z = torch.zeros_like(model.flat)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_update.fused_adam_kernel(model.flat, z, z.clone(), z.clone(),
                                      torch.tensor(0.0),
                                      cuda_update.AdamConsts(),
                                      ppo_cuda.make_fused_lr(PPOConfig()),
                                      tensor_sizes(kernel_order(HIDDEN)))


def test_gaussian_logp_entropy_and_gae_match_reference():
    from drone_tpu_torch import ppo as tppo

    rng = np.random.default_rng(7)
    a, m = (rng.normal(size=(64, 4)).astype(np.float32) for _ in range(2))
    ls = rng.normal(scale=0.3, size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tppo.gaussian_logp(torch.from_numpy(a), torch.from_numpy(m),
                           torch.from_numpy(ls)).numpy(),
        np.asarray(jppo.gaussian_logp(a, m, ls)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tppo.gaussian_entropy(torch.from_numpy(ls)).numpy(),
        np.asarray(jppo.gaussian_entropy(ls)), rtol=1e-6, atol=1e-6)
    T, B = 12, 32
    r, v = (rng.normal(size=(T, B)).astype(np.float32) for _ in range(2))
    d = rng.uniform(size=(T, B)) < 0.2
    last = rng.normal(size=B).astype(np.float32)
    want = jppo.compute_gae(r, v, d, last, 0.99, 0.95)
    got = tppo.compute_gae(*(torch.from_numpy(x) for x in (r, v, d, last)),
                           0.99, 0.95)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
