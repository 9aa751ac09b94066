"""The LSTM family's module and acting kernels (K8, K6): plain versions
against drone_tpu's.

`models.lstm.LSTMActorCritic` is held to the flax `LSTMActorCritic.apply`
on weights carried across by `params_from_flax`, within rtol 1e-5 / atol
1e-6 (torch and XLA round sigmoid, tanh and the sums differently by an ulp
or so). `lstm_act_rollout_cuda` (K8) and `traj_lstm_rollout_cuda` (K6) run
their plain PyTorch versions on CPU tensors; they are held to
`lstm_act_rollout_pallas(interpret=True)` and `traj_lstm_rollout_reference`
on the same env state and weights: carries, planes and anchors within rtol
1e-5 / atol 2e-6, episode counts equal. evaluate() and `cli eval` with
run.policy=lstm are held to the reference's evaluate.

The kernels themselves run only on the card (chip_smoke.py); here the
layouts they read are checked against the flat buffer.
"""

import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import drone_tpu
from drone_tpu import train as jtrain
from drone_tpu.models import LSTMActorCritic as FlaxLSTM
from drone_tpu.ops import pallas_acting_lstm as PAL
from drone_tpu.ops.pallas_acting_traj import pack_traj_planes
from drone_tpu.utils.config import Config as JaxConfig
from drone_tpu_torch import cli, train
from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import LSTMActorCritic, lstm_kernel_offsets
from drone_tpu_torch.models.lstm import (
    lstm_weights,
    params_from_flax,
    params_to_flax,
)
from drone_tpu_torch.ops import (
    cuda_acting_lstm,
    lstm_act_rollout_cuda,
    traj_lstm_rollout_cuda,
)
from drone_tpu_torch.types import default_params
from drone_tpu_torch.utils.checkpoint import Checkpointer
from drone_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
HOVER = ROOT / "configs" / "hover.toml"
H, ENC = 16, (16,)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(hidden=H, encoder=ENC, seed=0):
    """The same weights in both packages: (flax params, port module)."""
    fm = FlaxLSTM(hidden=hidden, encoder=encoder)
    params = fm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 13)),
                     fm.initial_carry((1,)))
    params = jax.tree_util.tree_map(np.asarray, params)
    model = LSTMActorCritic(hidden, encoder)
    model.load_state_dict(params_from_flax(params))
    return fm, params, model


def _close(a, b, err="", rtol=1e-5, atol=2e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=err)


def test_module_matches_flax():
    fm, params, model = _weights(encoder=(16, 8))
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(64, 13)).astype(np.float32)
    c, h = (rng.normal(size=(64, H)).astype(np.float32) for _ in range(2))
    mean, log_std, value, (c2, h2) = fm.apply(params, obs, (c, h))
    got = model(torch.from_numpy(obs), (torch.from_numpy(c),
                                        torch.from_numpy(h)))
    for name, a, b in (("mean", got[0], mean), ("log_std", got[1], log_std),
                       ("value", got[2], value), ("c", got[3][0], c2),
                       ("h", got[3][1], h2)):
        _close(a.detach(), b, name, atol=1e-6)


def test_params_to_flax_round_trip():
    _, params, model = _weights()
    back = params_to_flax(model)
    flat_a, tree_a = jax.tree_util.tree_flatten(back)
    flat_b, tree_b = jax.tree_util.tree_flatten(params)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("stray", ["conv1", "trunk"])
def test_param_tree_with_conv_pieces_but_no_conv0_is_refused(stray):
    """The reference's lstm_encoder_kind lets such a tree through as an
    empty dense encoder (ops/pallas_acting_lstm.py:140); the port refuses.
    A conv0 tree is the pixel-recurrent family, whose tower leaves no room
    for enc_h* layers beside it."""
    _, params, _ = _weights()
    bad = {"params": {**params["params"],
                      stray: {"kernel": np.zeros((4, 4), np.float32),
                              "bias": np.zeros(4, np.float32)}}}
    with pytest.raises(ValueError, match=stray):
        params_from_flax(bad)
    mixed = {"params": {**params["params"], "conv0": {}}}
    with pytest.raises(ValueError, match="enc_h0"):
        params_from_flax(mixed)


def test_flat_parameters_are_the_module_parameters():
    _, _, model = _weights(encoder=(16, 8))
    flat = model.flatten_()
    offs, total = lstm_kernel_offsets(H, (16, 8))
    assert flat.shape == (total,)
    for name, p in model.named_parameters():
        assert p.data_ptr() == flat[offs[name]:].data_ptr(), name
    enc, wi, wh, bh, head, vhead, ls = lstm_weights(flat, H, (16, 8))
    assert torch.equal(wi[2], model.lstm["ig"].weight)
    assert torch.equal(bh[3], model.lstm["ho"].bias)
    assert torch.equal(enc[1][0], model.enc_h1.weight)
    with torch.no_grad():
        flat[offs["log_std"]] = 0.25
    assert float(model.log_std.detach()[0]) == 0.25


def _jax_env(horizon):
    env = drone_tpu.DroneEnv()
    return env, env.params.replace(horizon=jnp.int32(horizon))


def test_plain_lstm_acting_matches_pallas_kernel():
    fm, params, model = _weights()
    N, T = 256, 10
    env, p = _jax_env(6)
    rng = np.random.default_rng(1)
    carry = tuple(rng.normal(scale=0.5, size=(N, H)).astype(np.float32)
                  for _ in range(2))
    _, want_carry, want = PAL.lstm_act_rollout_pallas(
        env.init_batch(5, N), params, carry, p, env.statics, T,
        interpret=True)
    tenv_ = tenv.DroneEnv(device="cpu")
    launches = lstm_act_rollout_cuda.launches
    _, got_carry, got = lstm_act_rollout_cuda(
        tenv_.init_batch(5, N), model.flatten_(), (H, ENC),
        tuple(torch.from_numpy(c) for c in carry),
        default_params("hover", horizon=6), tenv_.statics, T)
    assert lstm_act_rollout_cuda.launches == launches  # CPU: no kernel
    assert float(got["episodes"]) == float(want["episodes"]) >= N
    for k in want:
        _close(float(got[k]), float(want[k]), k)
    for a, b in zip(got_carry, want_carry):
        _close(a, b, "carry")


@pytest.mark.parametrize("stochastic", [False, True])
def test_plain_lstm_traj_matches_reference(stochastic):
    """K6's plain version against traj_lstm_rollout_reference: the planes,
    the anchors of every segment (seg_layout="planes") and the final
    carry, with episodes ending inside the segments."""
    fm, params, model = _weights()
    N, T, bptt = 256, 8, 4
    env, p = _jax_env(6)
    final, want_carry, traj, snap, want = PAL.traj_lstm_rollout_reference(
        env.init_batch(3, N), params, fm.initial_carry((N,)), p, env.statics,
        T, bptt=bptt, stochastic=stochastic, seg_layout="planes")
    tenv_ = tenv.DroneEnv(device="cpu")
    launches = traj_lstm_rollout_cuda.launches
    _, got_carry, planes, anchors, got = traj_lstm_rollout_cuda(
        tenv_.init_batch(3, N), model.flatten_(), (H, ENC),
        model.initial_carry(N), default_params("hover", horizon=6),
        tenv_.statics, T, bptt, stochastic)
    assert traj_lstm_rollout_cuda.launches == launches
    want_planes = np.asarray(pack_traj_planes(traj, N // 128))
    _close(planes, want_planes.reshape(T, -1, N), "planes")
    assert anchors.shape == (T // bptt, 2, H, N)
    _close(anchors, snap, "anchors")
    assert float(anchors[1].abs().max()) > 0  # a carried, nonzero anchor
    for a, b in zip(got_carry, want_carry):
        _close(a, b, "carry")
    assert float(got["episodes"]) == float(want["episodes"]) > 0


def test_net_layout_and_packed_gates_match_the_flat_buffer():
    encoder = (12, 20)
    model = LSTMActorCritic(8, encoder)
    flat = model.flatten_()
    offs, _ = lstm_kernel_offsets(8, encoder)
    ints = cuda_acting_lstm.net_layout(8, encoder)
    M = cuda_acting_lstm.MAX_ENC
    assert list(ints[:4]) == [2, 8, 12, 20]
    assert list(ints[2 + M:4 + M]) == [offs["enc_h0.weight"],
                                       offs["enc_h1.weight"]]
    assert list(ints[2 + 2 * M:]) == [offs["actor_mean.weight"],
                                      offs["critic_value.weight"],
                                      offs["log_std"]]
    # biases follow their weights, as the kernels assume
    assert offs["enc_h1.bias"] == offs["enc_h1.weight"] + 20 * 12
    assert offs["actor_mean.bias"] == offs["actor_mean.weight"] + 4 * 8
    wp, bp = cuda_acting_lstm.pack_gates(flat, 8, encoder)
    assert wp.shape == (20 + 8, 8, 4) and bp.shape == (8, 4)
    for g, gate in enumerate("ifgo"):
        assert torch.equal(wp[:20, :, g].t(), model.lstm[f"i{gate}"].weight)
        assert torch.equal(wp[20:, :, g].t(), model.lstm[f"h{gate}"].weight)
        assert torch.equal(bp[:, g], model.lstm[f"h{gate}"].bias)


@pytest.mark.parametrize("hidden,encoder", [(256, (64,)), (30, (16,)),
                                            (16, (8,) * 5)])
def test_net_layout_refuses_what_the_kernels_cannot_take(hidden, encoder):
    with pytest.raises(ValueError):
        cuda_acting_lstm.net_layout(hidden, encoder)


def test_lstm_kernels_refuse_cpu_tensors():
    model = LSTMActorCritic(H, ENC)
    env = tenv.DroneEnv(device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_acting_lstm.lstm_act_rollout_kernel(
            env.init_batch(0, 128), model.flatten_(), (H, ENC),
            model.initial_carry(128), env.params, env.statics, 2)


@pytest.mark.parametrize("episodes", [128, 64])
def test_evaluate_lstm_matches_jax(episodes):
    """128 episodes take the recurrent acting kernels in both packages (K8's
    plain version here, interpret-mode Pallas there); at 64 the reference
    takes its module rollout while the port still takes K8's plain
    version."""
    overrides = ["env.params.horizon=40", "run.policy=lstm",
                 "run.lstm_hidden=16", "run.hidden=16,16"]
    jcfg = JaxConfig.from_toml(HOVER).with_overrides(overrides)
    cfg = Config.from_toml(HOVER).with_overrides(overrides)
    _, params, model = _weights()
    want = jtrain.evaluate(jcfg, runner=types.SimpleNamespace(params=params),
                           episodes=episodes)
    launches = lstm_act_rollout_cuda.launches
    got = train.evaluate(cfg, runner=types.SimpleNamespace(params=model),
                         episodes=episodes, device="cpu")
    assert lstm_act_rollout_cuda.launches == launches
    assert got["episodes"] == want["episodes"] >= episodes
    for key in ("ep_return_mean", "ep_length_mean"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    np.testing.assert_allclose(got["ep_return_std"], want["ep_return_std"],
                               rtol=1e-3)


def test_stochastic_lstm_evaluate_goes_through_the_module(tmp_path, capsys):
    cfg = Config.from_toml(HOVER).with_overrides([
        "env.params.horizon=30", "run.policy=lstm", "run.lstm_hidden=16",
        "run.hidden=16"])
    model = LSTMActorCritic(16, (16,),
                            generator=torch.Generator().manual_seed(0))
    stats = train.evaluate(cfg, runner=types.SimpleNamespace(params=model),
                           episodes=32, deterministic=False, device="cpu")
    assert stats["episodes"] >= 32
    assert np.isfinite(stats["ep_return_mean"]) and stats["ep_return_std"] >= 0
    # cli eval restores the policy from a checkpoint
    Checkpointer(tmp_path).save(1, model)
    assert cli.main(["eval", str(HOVER), "--device", "cpu", "run.policy=lstm",
                     "run.lstm_hidden=16", "run.hidden=16",
                     f"run.resume_from={tmp_path}",
                     "env.params.horizon=20"]) == 0
    assert "episodes" in capsys.readouterr().out
