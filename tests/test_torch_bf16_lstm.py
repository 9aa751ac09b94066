"""bfloat16 recurrent training (run.policy=lstm|cnn_lstm
run.compute_dtype=bfloat16): the plain version of K7's bf16 operand arm,
dense and CNN encoder, one whole recurrent megakernel train step under
bfloat16, and build()'s routing, against drone_tpu's bf16 references on
the same weights (carried across by `params_from_flax`) and inputs, on
the CPU.

Tolerances: H12's rule for updates (tests/test_torch_bf16.py `_grads_close`:
each gradient tensor within GRAD_REL = 1e-3 of its largest |value|, the
mean difference to the reference's bf16 result under a tenth of its mean
difference to the reference's fp32 result). The recurrence carries a
rounding flip of h at step t into every later step of its segment, up to
bptt of them. Measured on these inputs, the plain bf16 arm against the
reference's bf16 mirror: at bptt 4 at most 2.3e-5 of a tensor's max
(dense) and 1.5e-5 (CNN), at bptt 16 (T 16) 2.8e-5 and 6.5e-5; the mean
difference 5e-11 to 2e-8 against 1.4e-6 to 1.6e-5 to the fp32 mirror. So
the rule holds with a wide margin and is not widened.
"""

import functools

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
from drone_tpu.ops import pallas_update as PU
from drone_tpu.ops import pallas_update_lstm as PUL
from drone_tpu_torch import ppo_cuda, ppo_rnn, ppo_rnn_cuda, train
from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import LSTMActorCritic, fused_opt_state_from_flax
from drone_tpu_torch.models.lstm import (
    lstm_kernel_order,
    params_from_flax,
    params_to_flax,
)
from drone_tpu_torch.ops import cuda_update, cuda_update_lstm, lstm_update_cuda
from drone_tpu_torch.ppo import PPOConfig
from drone_tpu_torch.ppo_rnn import init_recurrent_runner
from tests import test_torch_cnn_lstm as tcl
from tests import test_torch_update_lstm as tul
from tests.test_torch_bf16 import (
    GRAD_REL,
    SEPARATION,
    _grads_close,
    _step_close,
)

BF16 = "bfloat16"


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moved(model, critic_scale):
    """The weights moved off the planes' (noise on both heads, log_std up by
    0.1): every branch of the head's subgradients at a narrow vf_clip."""
    rng = np.random.default_rng(7)
    with torch.no_grad():
        for p, scale in ((model.actor_mean.weight, 0.1),
                         (model.actor_mean.bias, 0.1),
                         (model.critic_value.weight, critic_scale),
                         (model.critic_value.bias, critic_scale)):
            p += torch.from_numpy(
                (scale * rng.normal(size=tuple(p.shape))).astype(np.float32))
        model.log_std += 0.1
    return model


def _case(family, off_policy):
    """(flax params, port model flattened, numpy planes, advret, snap, the
    reference's UpdateConsts, arch, the reference's encoder kwargs) of one
    small fixture: test_torch_update_lstm's (H 16, encoder (16,)) or
    test_torch_cnn_lstm's (the small tower), two bptt-4 segments of 256
    lanes with episodes ending inside them."""
    if family == "dense":
        _, params, model, planes, advret, snap, *_, co = tul._fixture()
        arch, enc = (tul.H, tul.ENC), {}
        critic = 0.5
    else:
        _, params, model = tcl._weights()
        planes, advret, snap, *_ = tcl._reference(0)
        c = tcl._co()
        co = PU.UpdateConsts(clip_eps=c.clip_eps, vf_clip=c.vf_clip,
                             vf_coef=c.vf_coef, inv_m=c.inv_m)
        arch, enc = (tcl.H, tcl.ARCH), dict(encoder="cnn", geom=tcl.ARCH.geom)
        critic = 2.0
    if off_policy:
        model = _moved(model, critic)
        params = jax.tree_util.tree_map(jnp.asarray, params_to_flax(model))
        co = PU.UpdateConsts(clip_eps=co.clip_eps, vf_clip=0.2,
                             vf_coef=co.vf_coef, inv_m=co.inv_m)
    model.flatten_()
    return params, model, planes, advret, snap, co, arch, enc


@functools.lru_cache(maxsize=None)
def _jax_update(compute_dtype, bptt, encoder=None, geom=None):
    return jax.jit(functools.partial(
        PUL.ppo_lstm_update, bptt=bptt, rbu=1, sc=2, mode="reference",
        compute_dtype=compute_dtype,
        **({"encoder": encoder, "geom": geom} if encoder else {})),
        static_argnames=("co",))


@pytest.mark.parametrize("family", ["dense", "cnn"])
@pytest.mark.parametrize("off_policy", [False, True])
def test_plain_bf16_k7_matches_reference(family, off_policy):
    """K7's plain bf16 arm against ppo_lstm_update(mode="reference",
    compute_dtype="bfloat16") by H12's rule, at the weights that wrote the
    planes and off them (every branch taken); the stat sums within rtol
    GRAD_REL."""
    params, model, planes, advret, snap, co, arch, enc = _case(family,
                                                               off_policy)
    T, N, bptt = planes.shape[0], snap.shape[-1], 4
    perm = np.array([1, 0], np.int32)
    tensors, _ = PRP.lstm_kernel_tensors(params)
    want = {}
    for cd in ("float32", BF16):
        g, st = _jax_update(cd, bptt, **enc)(
            jnp.asarray(planes), jnp.asarray(advret), jnp.asarray(snap),
            jnp.asarray(perm), tensors[:-1], tensors[-1], co=co)
        want[cd] = (np.concatenate([np.asarray(t).reshape(-1) for t in g]
                                   + [np.asarray(st)[PU.ST_DLS0:]]),
                    np.asarray(st))
    args = (torch.from_numpy(np.array(planes)).reshape(T, -1, N),
            torch.from_numpy(np.array(advret)).reshape(2, T, N),
            torch.from_numpy(np.array(snap)), torch.from_numpy(perm),
            model.flat, arch,
            cuda_update.UpdateConsts(co.clip_eps, co.vf_clip, co.vf_coef,
                                     co.inv_m), 128, bptt)
    launches = (lstm_update_cuda.launches, lstm_update_cuda.bf16_launches)
    grads, stats = lstm_update_cuda(*args, compute_dtype=BF16)
    assert (lstm_update_cuda.launches,
            lstm_update_cuda.bf16_launches) == launches  # CPU: no kernel
    _grads_close(grads, want[BF16][0], want["float32"][0],
                 lstm_kernel_order(*arch), f"K7 bf16 {family}")
    np.testing.assert_allclose(stats.numpy(), want[BF16][1], rtol=GRAD_REL,
                               atol=1e-4 * np.abs(want[BF16][1]).max())
    n = cuda_update_lstm.lstm_head_branch_counts(*args, compute_dtype=BF16)
    if off_policy:
        assert min(n.values()) > 0, n
    else:
        # K6 wrote the planes in float32 and K7 recomputes the forward in
        # bf16: ratios move off 1, but stay inside 1 +- clip_eps here
        assert n["ratio_out"] == 0, n


def test_bf16_rnn_train_step_matches_reference_trainer():
    """One LSTM megakernel update under bfloat16 against the reference's
    (make_pallas_rnn_train_step(mode="reference", compute_dtype=
    "bfloat16", fused_optimizer=True)) on the same weights, env state and
    permutations: the rollout and the last value in float32 on both sides,
    K7's products in bf16."""
    cfg = tul.SMALL
    jcfg = jppo.PPOConfig(**cfg)
    jenv = drone_tpu.DroneEnv()
    jr = jrnn.init_recurrent_runner(FlaxLSTM(hidden=tul.H, encoder=tul.ENC),
                                    jenv, jcfg, seed=1)
    jr = jr.replace(opt_state=PRP.init_fused_opt_state(jr.params))
    jmu = {}
    for cd in ("float32", BF16):
        jstep = jax.jit(PRP.make_pallas_rnn_train_step(
            jppo.make_optimizer(jcfg), jenv.params, jenv.statics, jcfg,
            mode="reference", fused_optimizer=True, compute_dtype=cd))
        jr2, jm = jstep(jr)
        jmu[cd] = fused_opt_state_from_flax(jr2.opt_state)[1].numpy()
    _, kperm = jax.random.split(jr.key)
    n_rb = ppo_cuda.plan_minibatch_geometry(PPOConfig(**cfg), tul.N)[3]
    perms = np.stack([np.asarray(jax.random.permutation(k, n_rb))
                      for k in jax.random.split(kperm, jcfg.epochs)])

    env = tenv.DroneEnv(device="cpu")
    model = LSTMActorCritic(tul.H, tul.ENC)
    model.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr.params)))
    runner = init_recurrent_runner(model, env, PPOConfig(**cfg), seed=1)
    step = ppo_rnn_cuda.make_rnn_train_step(env, PPOConfig(**cfg),
                                            permutations=lambda r: perms,
                                            compute_dtype=BF16)
    r2, m = step(runner)
    mu = r2.opt_state[1].numpy()
    _step_close(m, jm, r2.params.state_dict(), params_from_flax(
        jax.tree_util.tree_map(np.asarray, jr2.params)), mu, jmu[BF16],
        "LSTM")
    # the first moments, the update's gradients, apart from float32's
    d16, d32 = (float(np.abs(mu - jmu[cd]).mean()) for cd in (BF16,
                                                              "float32"))
    assert d16 <= SEPARATION * d32, (d16, d32)
    for a, b in zip(r2.carry, jr2.carry):  # K6's carry, float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-6)


def _no_dtype(a, k) -> bool:
    """No compute dtype among a call's arguments."""
    return "compute_dtype" not in k and not any(
        isinstance(x, str) and x == BF16 for x in a)


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append((name, a, k))
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("policy", ["lstm", "cnn_lstm"])
def test_build_trains_bf16_recurrent_runs_on_the_megakernel_trainer(
        tmp_path, monkeypatch, policy):
    """Under run.compute_dtype=bfloat16 build() picks the recurrent
    megakernel trainer for both families and hands it the dtype; one
    update on the CPU sends every minibatch through K7's bf16 arm and the
    rollout (K6) and the last value through their float32 forms, which
    take no dtype."""
    over = ["run.compute_dtype=bfloat16"]
    if policy == "cnn_lstm":
        over += ["run.policy=cnn_lstm"]
    cfg = tul._cfg(tmp_path, "b", 1, over)
    _, model = train.build_env_and_model(cfg, device="cpu")
    assert train.trainer_kind(cfg, model) == "megakernel"
    calls = []
    for name in ("lstm_update_cuda", "traj_lstm_rollout_cuda", "lstm_value"):
        _spy(monkeypatch, ppo_rnn_cuda, name, calls)
    _, _, runner, step, bcfg = train.build(cfg, device="cpu")
    assert step.__module__ == ppo_rnn_cuda.__name__
    _, m = step(runner)
    assert np.isfinite(float(m["loss"]))
    n_mb = bcfg.train.epochs * bcfg.train.num_minibatches
    dtypes = [a[-1] for name, a, _ in calls if name == "lstm_update_cuda"]
    assert dtypes == [BF16] * n_mb
    for name, a, k in calls:
        if name != "lstm_update_cuda":
            assert _no_dtype(a, k), name


@pytest.mark.parametrize("tier,over", [
    ("scan", ["run.rollout=scan"]),
    ("hybrid", [f"train.num_envs={384}"]),
])
def test_bf16_hybrid_and_scan_tiers_train_float32(tmp_path, monkeypatch,
                                                  tier, over):
    """The recurrent hybrid and scan tiers take no compute dtype, as the
    reference's make_recurrent_train_step takes none: under bfloat16 they
    train the float32 module."""
    cfg = tul._cfg(tmp_path, "c", 1, ["run.compute_dtype=bfloat16", *over])
    _, model = train.build_env_and_model(cfg, device="cpu")
    assert train.trainer_kind(cfg, model) == tier
    calls = []
    _spy(monkeypatch, ppo_rnn, "make_recurrent_train_step", calls)
    _, params, _, step, _ = train.build(cfg, device="cpu")
    (_, a, k), = calls
    assert k.get("rollout") == ("scan" if tier == "scan" else "pallas")
    assert _no_dtype(a, k)
    assert all(p.dtype == torch.float32 for p in params.parameters())


def test_recurrent_trainer_and_k7_refuse_other_dtypes():
    """compute_dtype is float32 or bfloat16; any other raises ValueError
    naming it, at the trainer's build and at K7's wrapper."""
    env = tenv.DroneEnv(device="cpu")
    with pytest.raises(ValueError, match="float16"):
        ppo_rnn_cuda.make_rnn_train_step(env, PPOConfig(**tul.SMALL),
                                         compute_dtype="float16")
    *_, model, planes, advret, snap, _, _, co = tul._fixture()
    args = tul._port_args(planes, advret, snap, [0], model, co)
    with pytest.raises(ValueError, match="float16"):
        lstm_update_cuda(*args, compute_dtype="float16")
