"""The recurrent scan trainer and its hybrid tier
(`ppo_rnn.make_recurrent_train_step`), `segmented_forward`, and the LSTM
over an encoder module, on the CPU.

One recurrent scan update is held to the reference's
(`drone_tpu.ppo_rnn.make_recurrent_train_step(rollout="scan")`) on the
reference's own noise and permutations, and one hybrid update (K6's plain
version, which draws the lanes' counter-stream noise as the reference's
rollout mirror does) to its `rollout="pallas_ref"` on its permutations:
params, moments and metrics within rtol 1e-4 / atol 1e-6.
`segmented_forward` is held to the reference's on the same weights and
data, outputs and gradients.
"""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import drone_tpu
from drone_tpu import ppo as jppo
from drone_tpu import ppo_rnn as jrnn
from drone_tpu import ppo_rnn_pallas as PRP
from drone_tpu.models import LSTMActorCritic as FlaxLSTM
from drone_tpu.models.cnn import PatchCNNEncoder as FlaxPatchEncoder
from drone_tpu_torch import ppo, ppo_rnn, train
from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import (
    LSTMActorCritic,
    PatchCNNEncoder,
    fused_opt_state_from_flax,
)
from drone_tpu_torch.models.lstm import params_from_flax, params_to_flax
from drone_tpu_torch.ops import cuda_acting_lstm, cuda_update_lstm
from drone_tpu_torch.utils.config import Config

SMALL = dict(horizon=8, num_envs=64, epochs=2, num_minibatches=2,
             bptt_horizon=4, anneal_lr=True, total_updates=10)
HIDDEN, ENC = 16, (16,)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(a, b, err):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-6, err_msg=err)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference():
    """The reference's recurrent runner from seed 1 and its draws for one
    update: (model, env, cfg, runner, noise (T, N, 4), lane permutations
    (epochs, N))."""
    fmodel = FlaxLSTM(hidden=HIDDEN, encoder=ENC)
    jenv = drone_tpu.DroneEnv()
    jcfg = jppo.PPOConfig(**SMALL)
    jr = jax.jit(lambda: jrnn.init_recurrent_runner(fmodel, jenv, jcfg,
                                                    seed=1))()
    _, krollout, kperm = jax.random.split(jr.key, 3)
    noise = np.stack([np.asarray(jax.random.normal(k, (jcfg.num_envs, 4),
                                                   jnp.float32))
                      for k in jax.random.split(krollout, jcfg.horizon)])
    perms = np.stack([np.asarray(jax.random.permutation(k, jcfg.num_envs))
                      for k in jax.random.split(kperm, jcfg.epochs)])
    return fmodel, jenv, jcfg, jr, noise, perms


@pytest.mark.parametrize("rollout", ["scan", "pallas"])
def test_recurrent_update_matches_reference(reference, rollout):
    """rollout="scan" against the reference's scan tier (its noise and
    permutations fed in); "pallas", the hybrid tier, against its
    rollout="pallas_ref" (its permutations fed in)."""
    fmodel, jenv, jcfg, jr, noise, perms = reference
    jstep = jax.jit(jrnn.make_recurrent_train_step(
        fmodel.apply, jppo.make_optimizer(jcfg), jenv.params, jenv.statics,
        jcfg, rollout="scan" if rollout == "scan" else "pallas_ref"))
    jr2, jm = jstep(jr)

    cfg = ppo.PPOConfig(**SMALL)
    env = tenv.DroneEnv(device="cpu")
    model = LSTMActorCritic(HIDDEN, ENC)
    model.load_state_dict(params_from_flax(_np(jr.params)))
    runner = ppo_rnn.init_recurrent_runner(model, env, cfg, seed=1)
    step = ppo_rnn.make_recurrent_train_step(
        model, env, cfg, rollout=rollout, permutations=lambda r: perms,
        noise=lambda r: torch.from_numpy(noise))
    r2, m = step(runner)

    assert set(m) == set(jm) == set(ppo.METRIC_KEYS)
    for k in jm:
        _close(m[k], jm[k], k)
    want = params_from_flax(_np(jr2.params))
    for name, t in r2.params.state_dict().items():
        _close(t, want[name], name)
    jcount, jmu, jnu = fused_opt_state_from_flax(
        PRP.optax_to_fused_opt_state(jr2.opt_state))
    assert float(r2.opt_state[0]) == float(jcount) == 4.0
    _close(r2.opt_state[1], jmu, "mu")
    _close(r2.opt_state[2], jnu, "nu")
    for a, b in zip(r2.carry, jr2.carry):
        _close(a, b, "carry")


def _segment_inputs(T=8, L=6, seed=0):
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T, L, 13)).astype(np.float32)
    done = rng.uniform(size=(T, L)) < 0.2
    return obs, done


def _flax_params(fmodel, model):
    """The port's weights as the flax tree of `fmodel` (params_to_flax),
    checked against the tree flax's init would make (its structure and
    shapes, traced, not run), and converted back bitwise."""
    tree = params_to_flax(model)
    shapes = jax.eval_shape(fmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 13)), fmodel.initial_carry((1,)))
    assert (jax.tree_util.tree_structure(shapes)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(shapes),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape
    back = params_from_flax(tree)
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name
    return tree


def _models(seed=2):
    model = LSTMActorCritic(8, (8,),
                            generator=torch.Generator().manual_seed(seed))
    fmodel = FlaxLSTM(hidden=8, encoder=(8,))
    return fmodel, _flax_params(fmodel, model), model


def test_segmented_forward_matches_reference_with_gradients():
    """Two segments (bptt 4 of T 8) from random anchors: the outputs and
    the gradient of a weighted sum of them, with respect to every
    parameter, against the reference's segmented_forward."""
    fmodel, params, model = _models()
    obs, done = _segment_inputs()
    T, L = done.shape
    rng = np.random.default_rng(1)
    c0 = tuple(rng.normal(size=(2, L, 8)).astype(np.float32)
               for _ in range(2))
    w = rng.normal(size=(T, L)).astype(np.float32)

    def jloss(p):
        m, ls, v = jrnn.segmented_forward(fmodel.apply, p, obs, done, c0, 4)
        return jnp.sum(w * v) + jnp.sum(w[..., None] * m), (m, v)

    (_, (jm, jv)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    m, ls, v = ppo_rnn.segmented_forward(
        model, torch.from_numpy(obs), torch.from_numpy(done),
        tuple(torch.from_numpy(c) for c in c0), 4)
    wt = torch.from_numpy(w)
    (torch.sum(wt * v) + torch.sum(wt[..., None] * m)).backward()
    _close(m.detach(), jm, "mean")
    _close(v.detach(), jv, "value")
    assert ls.shape == (T, L, 4)
    want = params_from_flax(_np(jg))
    for name, p in model.named_parameters():
        # log_std reaches neither the mean nor the value
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        _close(grad, want[name], name)


def test_segmented_forward_equals_full_pass_and_truncates_gradients():
    """bptt == T is the unsegmented pass; with bptt < T the gradient of a
    late segment's values with respect to an earlier segment's obs is
    exactly zero, and with full BPTT it is not."""
    _, _, model = _models()
    obs_np, done_np = _segment_inputs()
    T, L = done_np.shape
    obs, done = torch.from_numpy(obs_np), torch.from_numpy(done_np)
    carry = model.initial_carry(L)
    outs, anchors, c = [], [], carry
    with torch.no_grad():
        for t in range(T):
            if t % 4 == 0:
                anchors.append(c)
            mean, _, value, c = model(obs[t], c)
            c = ppo_rnn.mask_carry(c, done[t])
            outs.append((mean, value))
    m, _, v = ppo_rnn.segmented_forward(
        model, obs, done, tuple(x[None] for x in carry), T)
    assert torch.equal(m.detach(), torch.stack([o[0] for o in outs]))
    assert torch.equal(v.detach(), torch.stack([o[1] for o in outs]))

    nodone = torch.zeros(T, L, dtype=torch.bool)
    anchors = tuple(torch.stack([a[k] for a in anchors]) for k in range(2))

    def early_grad(c0, bptt):
        x = obs.clone().requires_grad_(True)
        _, _, val = ppo_rnn.segmented_forward(model, x, nodone, c0, bptt)
        (g,) = torch.autograd.grad(val[4:].sum(), x)
        return float(g[:4].abs().max())

    assert early_grad(anchors, 4) == 0.0
    assert early_grad(tuple(a[:1] for a in anchors), T) > 1e-6


def _encoder_models():
    kw = dict(res=8, patch0=2, patch1=2, channels=(8, 8), hidden=16)
    fmodel = FlaxLSTM(hidden=HIDDEN, encoder_module=FlaxPatchEncoder(**kw))
    model = LSTMActorCritic(HIDDEN, encoder_module=PatchCNNEncoder(
        **kw, generator=torch.Generator().manual_seed(3)))
    return fmodel, model


def test_lstm_over_an_encoder_module_matches_flax():
    """LSTMActorCritic(encoder_module=PatchCNNEncoder(...)) against the
    reference's on the same weights; the converters round-trip to flax's
    tree; its flat order is the module's own; every LSTM kernel's envelope
    check refuses it, naming encoder_module, so evaluate() serves it
    through the module."""
    fmodel, model = _encoder_models()
    params = _flax_params(fmodel, model)
    obs = np.random.default_rng(4).normal(size=(5, 13)).astype(np.float32)
    rng = np.random.default_rng(5)
    carry = tuple(rng.normal(size=(5, HIDDEN)).astype(np.float32)
                  for _ in range(2))
    want = jax.jit(fmodel.apply)(params, obs, carry)
    got = model(torch.from_numpy(obs), tuple(map(torch.from_numpy, carry)))
    for a, b in zip([*got[:3], *got[3]], [*want[:3], *want[3]]):
        _close(a.detach(), b, "forward")
    assert [n for n, _ in model.kernel_order()] == [
        n for n, _ in model.named_parameters()]
    assert model.kernel_order()[1][0] == "encoder_module.conv0.weight"
    for check in (cuda_update_lstm.check_envelope,
                  cuda_acting_lstm.check_act_envelope):
        with pytest.raises(ValueError, match="encoder_module"):
            check(model.hidden, model.encoder)
    cfg = Config.default().with_overrides(["run.policy=lstm",
                                           f"run.lstm_hidden={HIDDEN}",
                                           "env.params.horizon=5"])

    def refuse(*a, **k):
        raise AssertionError("an acting kernel's wrapper was called")

    orig = train.lstm_act_rollout_cuda
    train.lstm_act_rollout_cuda = refuse
    try:
        stats = train.evaluate(cfg, runner=types.SimpleNamespace(
            params=model), episodes=16, device="cpu")
    finally:
        train.lstm_act_rollout_cuda = orig
    assert stats["episodes"] == 16 and np.isfinite(stats["ep_return_mean"])


def test_lstm_over_an_encoder_module_trains_on_the_scan_tier():
    """One scan update of the encoder-module LSTM: K4 over its own flat
    order, finite metrics, the parameters moved."""
    _, model = _encoder_models()
    cfg = ppo.PPOConfig(**SMALL)
    env = tenv.DroneEnv(device="cpu")
    runner = ppo_rnn.init_recurrent_runner(model, env, cfg, seed=0)
    before = runner.params.flat.clone()
    r2, m = ppo_rnn.make_recurrent_train_step(model, env, cfg)(runner)
    assert all(torch.isfinite(v) for v in m.values())
    assert float(r2.opt_state[0]) == 4.0
    assert not torch.equal(before, r2.params.flat)
