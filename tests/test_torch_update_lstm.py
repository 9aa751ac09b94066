"""K7 (the truncated-BPTT update), K4 over the LSTM layout and the recurrent
trainer: plain versions against drone_tpu's.

`lstm_update_cuda` runs its plain PyTorch version on CPU tensors. It is
held to `pallas_update_lstm.ppo_lstm_update(mode="reference")` on the same
planes, anchors and a shuffled row-block minibatch with 2 bptt segments
and episodes ending inside them, at the weights that wrote the planes and
off them (every branch of the head's subgradients taken), and to jax.grad
of the segmented-forward PPO loss, as tests/test_pallas_update_lstm.py
holds the reference: gradients within rtol 2e-4 / atol 2e-6 (the sums run
in another order), stat sums within rtol 2e-4 / atol 2e-5 (two of them
cancel to ~0). One whole
train step is held to `make_pallas_rnn_train_step(mode="reference",
fused_optimizer=True)` under the reference's own permutations: params,
optimizer state, carry and metrics within rtol 1e-4 / atol 1e-6.
"""

import functools
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
from drone_tpu.models import LSTMActorCritic as FlaxLSTM
from drone_tpu.ops import pallas_acting_lstm as PAL
from drone_tpu.ops import pallas_acting_traj as PAT
from drone_tpu.ops import pallas_update as PU
from drone_tpu.ops import pallas_update_lstm as PUL
from drone_tpu_torch import cli, ppo_cuda, ppo_rnn_cuda, train
from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import (
    LSTMActorCritic,
    fused_opt_state_from_flax,
    tensor_sizes,
)
from drone_tpu_torch.models.lstm import (
    fused_opt_state_to_flax,
    lstm_kernel_offsets,
    lstm_kernel_order,
    params_from_flax,
    params_to_flax,
)
from drone_tpu_torch.ops import (
    cuda_update,
    cuda_update_lstm,
    fused_adam_cuda,
    lstm_update_cuda,
)
from drone_tpu_torch.ppo import PPOConfig
from drone_tpu_torch.ppo_rnn import init_recurrent_runner
from drone_tpu_torch.utils.checkpoint import Checkpointer
from drone_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
HOVER = ROOT / "configs" / "hover.toml"
H, ENC = 16, (16,)
N, T, BPTT = 256, 8, 4


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(seed=0):
    """A reference LSTM rollout's planes and anchors (episodes of 6 steps,
    so resets fall inside the segments), GAE advantages, and the same
    weights in both packages (the port's model made anew per call, as
    tests move it)."""
    fm, params, planes, advret, snap, traj, seg_batch, co = _reference(seed)
    model = LSTMActorCritic(H, ENC)
    model.load_state_dict(params_from_flax(params))
    model.flatten_()
    return fm, params, model, planes, advret, snap, traj, seg_batch, co


@functools.lru_cache(maxsize=None)
def _reference(seed):
    env = drone_tpu.DroneEnv()
    fm = FlaxLSTM(hidden=H, encoder=ENC)
    params = jax.tree_util.tree_map(np.asarray, fm.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 13)), fm.initial_carry((1,))))
    p = env.params.replace(horizon=jnp.int32(6))
    final, carry, traj, snap, _ = PAL.traj_lstm_rollout_reference(
        env.init_batch(3, N), params, fm.initial_carry((N,)), p, env.statics,
        T, bptt=BPTT, seg_layout="planes")
    rows = N // 128
    planes = PAT.pack_traj_planes(traj, rows)
    last_value = PRP._lstm_value(env.observe_batch(final), carry,
                                 params).reshape(rows, 128)
    advret = ppo_pallas.normalized_advret(planes, last_value,
                                          jppo.PPOConfig(), None)
    co = PU.UpdateConsts(clip_eps=0.2, vf_clip=10.0, vf_coef=0.5,
                         inv_m=1.0 / (N * T))
    seg_batch = (snap[:, 0].transpose(0, 2, 1), snap[:, 1].transpose(0, 2, 1))
    return (fm, params, np.asarray(planes), np.asarray(advret),
            np.asarray(snap), traj, seg_batch, co)


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_args(planes, advret, snap, perm, model, co):
    return (_t(planes).reshape(T, -1, N), _t(advret).reshape(2, T, N),
            _t(snap), torch.from_numpy(np.asarray(perm, np.int32)), model.flat,
            (H, ENC), cuda_update.UpdateConsts(co.clip_eps, co.vf_clip,
                                               co.vf_coef, co.inv_m),
            128, BPTT)


def _reference_flat(grads, st):
    return np.concatenate([np.asarray(g).reshape(-1) for g in grads]
                          + [np.asarray(st)[PU.ST_DLS0:PU.ST_DLS0 + 4]])


def _update_against_reference(params, model, planes, advret, snap, co):
    perm = np.array([1, 0], np.int32)
    tensors, _ = PRP.lstm_kernel_tensors(params)
    want, st = PUL.ppo_lstm_update(
        jnp.asarray(planes), jnp.asarray(advret), jnp.asarray(snap),
        jnp.asarray(perm), tensors[:-1], tensors[-1], bptt=BPTT, co=co,
        rbu=1, sc=2, mode="reference")
    launches = lstm_update_cuda.launches
    grads, stats = lstm_update_cuda(*_port_args(planes, advret, snap, perm,
                                                model, co))
    assert lstm_update_cuda.launches == launches  # CPU tensors: no kernel
    np.testing.assert_allclose(grads.numpy(), _reference_flat(want, st),
                               rtol=2e-4, atol=2e-6)
    # on-policy the policy-loss and approx-KL sums cancel to ~0 over 2,048
    # samples of order 1 (normalized advantages), so their rounding in
    # another order is absolute: atol 2e-5, ~1e-8 a sample
    np.testing.assert_allclose(stats.numpy(), np.asarray(st), rtol=2e-4,
                               atol=2e-5)
    return stats


def test_plain_update_matches_reference():
    _, params, model, planes, advret, snap, *_, co = _fixture()
    _update_against_reference(params, model, planes, advret, snap, co)


def test_plain_update_matches_reference_off_policy():
    """At weights moved off the planes' (noise on both heads, log_std up by
    0.1, a narrow vf_clip) every branch of the head's subgradients is
    taken, and the approx-KL and clip-fraction sums are nonzero."""
    _, _, model, planes, advret, snap, *_, co = _fixture()
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for p, scale in ((model.actor_mean.weight, 0.1),
                         (model.actor_mean.bias, 0.1),
                         (model.critic_value.weight, 0.5),
                         (model.critic_value.bias, 0.5)):
            p += torch.from_numpy(
                (scale * rng.normal(size=tuple(p.shape))).astype(np.float32))
        model.log_std += 0.1
    co = PU.UpdateConsts(clip_eps=co.clip_eps, vf_clip=0.2,
                         vf_coef=co.vf_coef, inv_m=co.inv_m)
    args = _port_args(planes, advret, snap, [1, 0], model, co)
    n = cuda_update_lstm.lstm_head_branch_counts(*args)
    assert n["ratio_out"] > n["policy_grad_zero"] > 0, n
    assert n["value_out"] > n["value_grad_zero"] > 0, n
    params = jax.tree_util.tree_map(jnp.asarray, params_to_flax(model))
    stats = _update_against_reference(params, model, planes, advret, snap, co)
    assert float(stats[cuda_update.ST_KL]) != 0.0
    assert float(stats[cuda_update.ST_CF]) > 0.0


def test_plain_update_matches_jax_grad():
    """The hand-written BPTT against jax.grad of the segmented_forward PPO
    loss (tests/test_pallas_update_lstm.py's template): truncation at the
    segment anchors, done-masked carries and the log_std gradient with its
    entropy term."""
    fm, params, model, planes, advret, snap, traj, seg_batch, co = _fixture()
    ent_coef = 0.01
    grads, _ = lstm_update_cuda(*_port_args(planes, advret, snap, [0, 1],
                                            model, co), ent_coef=ent_coef)
    adv = jnp.asarray(advret[0]).reshape(T, N)
    ret = jnp.asarray(advret[1]).reshape(T, N)

    def loss_fn(prm):
        mean, log_std, value = jrnn.segmented_forward(
            fm.apply, prm, traj.obs, traj.done, seg_batch, BPTT)
        logp = jppo.gaussian_logp(traj.action, mean, log_std)
        ratio = jnp.exp(logp - traj.logp)
        pg = jnp.maximum(-adv * ratio, -adv * jnp.clip(ratio, 0.8, 1.2))
        v_clipped = traj.value + jnp.clip(value - traj.value, -10.0, 10.0)
        v_loss = 0.5 * jnp.mean(jnp.maximum((value - ret) ** 2,
                                            (v_clipped - ret) ** 2))
        ent = jnp.mean(jppo.gaussian_entropy(log_std))
        return jnp.mean(pg) + 0.5 * v_loss - ent_coef * ent

    want = params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray,
                                                             params))))
    offs, _ = lstm_kernel_offsets(H, ENC)
    for name, shape in lstm_kernel_order(H, ENC):
        got = grads[offs[name]:offs[name] + int(np.prod(shape))]
        np.testing.assert_allclose(got.numpy(),
                                   want[name].numpy().reshape(-1),
                                   rtol=2e-4, atol=2e-6, err_msg=name)


def test_update_log_std_gradient_carries_the_entropy_term():
    _, _, model, planes, advret, snap, *_, co = _fixture()
    args = _port_args(planes, advret, snap, [0], model, co)
    g0, st0 = lstm_update_cuda(*args)
    g1, st1 = lstm_update_cuda(*args, ent_coef=0.25)
    ls = lstm_kernel_offsets(H, ENC)[0]["log_std"]
    assert torch.equal(st0, st1) and torch.equal(g0[:ls], g1[:ls])
    torch.testing.assert_close(g1[ls:], st0[cuda_update.ST_DLS0:] - 0.25)


def test_grad_products_cover_the_flat_buffer():
    """K7's weight-gradient products: every parameter but log_std reads one
    entry of one product, and the gate blocks hold [Wi | Wh | bh] per
    unit."""
    encoder = (12, 20)
    pairs, ptot, mp = cuda_update_lstm.grad_products(8, encoder)
    offs, P = lstm_kernel_offsets(8, encoder)
    assert mp.shape == (P,)
    used = mp[mp >= 0]
    assert len(used) == P - 4 and len(set(used.tolist())) == len(used)
    assert list(mp[offs["log_std"]:]) == [-1, -2, -3, -4]
    assert int(pairs[:, 2].dot(pairs[:, 5] + 1)) == ptot
    gate = pairs[2]
    assert list(gate[:6]) == [cuda_update_lstm.GZ, 0, 32,
                              cuda_update_lstm.XS, 13 + 12, 20 + 8]
    o, W = int(gate[6]), 20 + 8 + 1
    # unit 3 of gate f: its input weights, recurrent weights and bias
    u = 8 + 3
    assert mp[offs["lstm.if.weight"] + 3 * 20] == o + u * W
    assert mp[offs["lstm.hf.weight"] + 3 * 8] == o + u * W + 20
    assert mp[offs["lstm.hf.bias"] + 3] == o + u * W + 28
    rows = cuda_update_lstm.scratch_rows(8, encoder)
    assert rows[cuda_update_lstm.XS] == 13 + 32 + 8


def test_plain_adam_over_the_lstm_layout_matches_reference():
    _, params, model, *_ = _fixture()
    tensors, _ = PRP.lstm_kernel_tensors(params)
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
    _, params, *_ = _fixture()
    count, mu, nu = PRP.init_fused_opt_state(params)
    rng = np.random.default_rng(0)
    mu = [rng.normal(size=np.shape(t)).astype(np.float32) for t in mu]
    nu = [rng.uniform(size=np.shape(t)).astype(np.float32) for t in nu]
    state = fused_opt_state_from_flax((np.float32(9.0), mu, nu))
    c2, mu2, nu2 = fused_opt_state_to_flax(state, H, ENC)
    assert float(c2) == 9.0
    for a, b in zip(mu + nu, mu2 + nu2):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


SMALL = dict(horizon=T, num_envs=N, epochs=2, num_minibatches=2,
             bptt_horizon=BPTT, anneal_lr=True, total_updates=10)


def _close(a, b, err):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-6, err_msg=err)


def test_train_step_matches_reference_trainer():
    jcfg = jppo.PPOConfig(**SMALL)
    jenv = drone_tpu.DroneEnv()
    fm = FlaxLSTM(hidden=H, encoder=ENC)
    jr = jrnn.init_recurrent_runner(fm, jenv, jcfg, seed=1)
    jr = jr.replace(opt_state=PRP.init_fused_opt_state(jr.params))
    jstep = jax.jit(PRP.make_pallas_rnn_train_step(
        jppo.make_optimizer(jcfg), jenv.params, jenv.statics, jcfg,
        mode="reference", fused_optimizer=True))
    _, kperm = jax.random.split(jr.key)
    n_rb = ppo_cuda.plan_minibatch_geometry(PPOConfig(**SMALL), N)[3]
    perms = np.stack([np.asarray(jax.random.permutation(k, n_rb))
                      for k in jax.random.split(kperm, jcfg.epochs)])
    jr2, jm = jstep(jr)

    env = tenv.DroneEnv(device="cpu")
    model = LSTMActorCritic(H, ENC)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr.params)))
    runner = init_recurrent_runner(model, env, PPOConfig(**SMALL), seed=1)
    step = ppo_rnn_cuda.make_rnn_train_step(env, PPOConfig(**SMALL),
                                            permutations=lambda r: perms)
    r2, m = step(runner)

    assert set(m) == set(jm) == set(ppo_cuda.METRIC_KEYS)
    for k in jm:
        _close(m[k], jm[k], k)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jr2.params))
    for name, t in r2.params.state_dict().items():
        _close(t, want[name], name)
    count, mu, nu = fused_opt_state_to_flax(r2.opt_state, H, ENC)
    jcount, jmu, jnu = jr2.opt_state
    assert float(count) == float(jcount) == 4.0
    for i, (a, b) in enumerate(zip(mu + nu, list(jmu) + list(jnu))):
        assert a.shape == np.asarray(b).shape
        _close(a, b, f"moment {i}")
    for a, b in zip(r2.carry, jr2.carry):
        _close(a, b, "carry")
    assert r2.update_idx == int(jr2.update_idx) == 1


def _cfg(tmp_path, name, total, extra=()):
    return Config.default().with_overrides([
        "run.policy=lstm", "run.lstm_hidden=16", "run.hidden=16,16",
        f"train.num_envs={N}", f"train.horizon={T}",
        f"train.bptt_horizon={BPTT}", "train.epochs=2",
        "train.num_minibatches=2", "run.log_interval=1",
        "run.checkpoint_interval=100", f"run.total_updates={total}",
        f"run.run_name={name}", f"run.checkpoint_dir={tmp_path}", *extra])


def test_lstm_resume_is_bitwise(tmp_path):
    """train(4) == train(2) + resume(2): every tensor of the runner, the
    LSTM carry included, through a checkpoint round trip."""
    full, _ = train.train(_cfg(tmp_path, "full", 4), device="cpu")
    train.train(_cfg(tmp_path, "half", 2), device="cpu")
    ckpt = tmp_path / "half" / "checkpoints"
    raw, step = Checkpointer(ckpt).restore_raw()
    assert step == 2 and raw["carry"]["c"].shape == (N, H)
    resumed, last = train.train(
        _cfg(tmp_path, "resumed", 4, [f"run.resume_from={ckpt}"]),
        device="cpu")
    assert resumed.update_idx == full.update_idx == 4

    def tensors(r):
        return [*r.params.state_dict().values(), *r.opt_state,
                r.env_state.fstate(), r.env_state.step, *r.carry,
                r.generator.get_state()]

    for a, b in zip(tensors(full), tensors(resumed)):
        assert torch.equal(a, b)
    assert float(full.carry[1].abs().max()) > 0
    assert np.isfinite(last["loss"])


def test_cli_train_then_eval_lstm_on_cpu(tmp_path, capsys):
    over = ["--device", "cpu", "run.policy=lstm", "run.lstm_hidden=16",
            "run.hidden=16"]
    assert cli.main(["train", str(HOVER), *over, f"train.num_envs={N}",
                     "train.horizon=8", "train.bptt_horizon=4",
                     "train.num_minibatches=2", "train.epochs=1",
                     "run.total_updates=2", f"run.checkpoint_dir={tmp_path}",
                     "run.run_name=cli"]) == 0
    capsys.readouterr()
    assert cli.main(["eval", str(HOVER), *over,
                     f"run.resume_from={tmp_path}/cli/checkpoints",
                     "env.params.horizon=10"]) == 0
    assert '"episodes"' in capsys.readouterr().out


def test_lstm_train_refuses_a_horizon_that_does_not_split(tmp_path):
    with pytest.raises(ValueError, match="bptt"):
        train.build(_cfg(tmp_path, "y", 1, ["train.bptt_horizon=3"]),
                    device="cpu")
