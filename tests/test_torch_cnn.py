"""The patch-CNN family's pixels, module and acting kernels (K11, K9): plain
versions against drone_tpu's.

`pixels.patch_grid` equals the reference's bit for bit (it gathers from
jnp.linspace, which the port rebuilds on the host). `obs_to_pixels`,
`splat_planes`, `cnn_forward` and `PatchCNNActorCritic` are held to the
reference's pixels, plane-space functions and flax `apply` on weights
carried across by `params_from_flax`, within rtol 1e-5 (torch and XLA round
exp, sqrt and the sums differently by an ulp or so). `cnn_act_rollout_cuda`
(K11) and `traj_cnn_rollout_cuda` (K9) run their plain versions on CPU
tensors; they are held to `traj_cnn_rollout_reference` on the same env
state and weights: planes and final state within rtol 1e-5 / atol 2e-6,
episode counts equal. The reference's small test geometry (res 8, 2x2
patches, channels (8, 8), hidden 16) keeps them fast; a few lanes run at the
default geometry, which the kernels take.
"""

import types
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import drone_tpu
from drone_tpu import pixels as jpixels
from drone_tpu import train as jtrain
from drone_tpu.models import PatchCNNActorCritic as FlaxCNN
from drone_tpu.models import PixelActorCritic
from drone_tpu.ops import pallas_acting_cnn as PAC
from drone_tpu.ops.pallas_acting_traj import pack_traj_planes
from drone_tpu.utils.config import Config as JaxConfig
from drone_tpu_torch import cli, pixels, train
from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import PatchCNNActorCritic, cnn_kernel_offsets
from drone_tpu_torch.models.cnn import (
    cnn_all_weights,
    params_from_flax,
    params_to_flax,
)
from drone_tpu_torch.ops import (
    cnn_act_rollout_cuda,
    cuda_acting_cnn,
    traj_cnn_rollout_cuda,
)
from drone_tpu_torch.types import default_params
from drone_tpu_torch.utils.checkpoint import Checkpointer
from drone_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
HOVER = ROOT / "configs" / "hover.toml"
SMALL = dict(res=8, patch0=2, patch1=2, channels=(8, 8), hidden=16)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(kw=SMALL, seed=0):
    """The same weights in both packages: (flax module, params, port
    module); kw the module's geometry ({} for the defaults)."""
    fm = FlaxCNN(**kw)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(fm.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 13), jnp.float32)))
    model = PatchCNNActorCritic(**kw)
    model.load_state_dict(params_from_flax(params))
    return fm, params, model


def _close(a, b, err="", rtol=1e-5, atol=2e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=err)


def _obs(n, seed=1):
    return np.random.default_rng(seed).normal(size=(n, 13)).astype(np.float32)


@pytest.mark.parametrize("res,patch", [(8, 2), (24, 4)])
def test_patch_grid_is_the_reference_bitwise(res, patch):
    want = [np.asarray(g)[:, 0] for g in jpixels.patch_grid(res, patch)]
    got = [g.numpy() for g in pixels.patch_grid(res, patch)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    lin = np.asarray(jnp.linspace(-1.0, 1.0, res))
    np.testing.assert_array_equal(pixels.linspace_np(res).view(np.uint32),
                                  lin.view(np.uint32))


@pytest.mark.parametrize("res", [8, 24])
def test_obs_to_pixels_matches_jax(res):
    obs = _obs(128)
    want = np.asarray(jpixels.obs_to_pixels(jnp.asarray(obs), res))
    got = pixels.obs_to_pixels(torch.from_numpy(obs), res)
    assert got.shape == (128, res, res, 4)
    _close(got, want, atol=1e-6)
    for g, w in zip(pixels.splat_inputs(torch.from_numpy(obs)),
                    jpixels.splat_inputs(jnp.asarray(obs))):
        for a, b in zip(g, w):
            _close(a, b, atol=1e-6)


def test_splat_planes_and_render_match_the_reference():
    obs = _obs(256, seed=2)
    geom = PAC.CnnGeom(8, 2, 2)
    want = PAC.splat_planes(jnp.asarray(obs).T)
    got = cuda_acting_cnn.splat_planes(torch.from_numpy(obs))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            _close(a, np.asarray(b)[0], atol=1e-6)
    gx, gy = jpixels.patch_grid(8, 2)
    X0 = cuda_acting_cnn.render_patches(got, *pixels.patch_grid(8, 2),
                                        cuda_acting_cnn.CnnGeom(8, 2, 2))
    for p in (0, 5, 15):
        blk = PAC.render_patch(want, gx[4 * p:4 * p + 4], gy[4 * p:4 * p + 4])
        _close(X0[:, p], np.asarray(blk).T, atol=1e-6)
    assert X0.shape == (256, geom.n_q0, 16)


@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "default"])
def test_module_and_cnn_forward_match_flax(kw):
    fm, params, model = _weights(kw)
    obs = _obs(64)
    mean, log_std, value = jax.jit(fm.apply)(params, obs)
    got = model(torch.from_numpy(obs))
    for name, a, b in (("mean", got[0], mean), ("log_std", got[1], log_std),
                       ("value", got[2], value)):
        _close(a.detach(), b, name, atol=1e-6)
    # the kernels' plane-space formulation, against the reference's
    geom = PAC.infer_cnn_geom(params["params"])
    gx, gy = jpixels.patch_grid(geom.res, geom.p0)
    mk, vk = jax.jit(lambda x, prm: PAC.cnn_forward(
        x, PAC.cnn_all_weights(prm, geom), gx, gy, geom, jnp.float32))(
            jnp.asarray(obs).T, params)
    arch = model.arch
    m, v = cuda_acting_cnn.cnn_forward(
        torch.from_numpy(obs), cnn_all_weights(model.flatten_(), arch),
        *pixels.patch_grid(arch.res, arch.p0), arch.geom)
    _close(m, np.asarray(mk).T, "plane mean", atol=1e-6)
    _close(v, np.asarray(vk)[0], "plane value", atol=1e-6)
    assert cuda_acting_cnn.infer_cnn_arch(model.state_dict()) == arch
    assert cuda_acting_cnn.infer_cnn_geom(model.state_dict()) == arch.geom


def test_params_to_flax_round_trip():
    _, params, model = _weights()
    back = params_to_flax(model)
    flat_a, tree_a = jax.tree_util.tree_flatten(back)
    flat_b, tree_b = jax.tree_util.tree_flatten(params)
    assert tree_a == tree_b
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_flat_parameters_are_the_module_parameters():
    model = PatchCNNActorCritic(generator=torch.Generator().manual_seed(0))
    flat = model.flatten_()
    offs, total = cnn_kernel_offsets(model.arch)
    assert flat.shape == (total,) == (95113,)
    for name, p in model.named_parameters():
        assert p.data_ptr() == flat[offs[name]:].data_ptr(), name
    W0, b0, W1, b1, Wt, bt, head, vhead, ls = cnn_all_weights(flat,
                                                              model.arch)
    assert torch.equal(W1, model.conv1.weight)
    assert torch.equal(vhead[0], model.critic_value.weight)
    # flax's initialisers: lecun-normal conv and trunk kernels, zero biases
    for w in (W0, W1, Wt):
        assert abs(float(w.std()) * w.shape[1] ** 0.5 - 1.0) < 0.1
    assert float(b1.abs().max()) == 0.0 and float(ls.abs().max()) == 0.0
    with torch.no_grad():
        flat[offs["log_std"]] = 0.25
    assert float(model.log_std.detach()[0]) == 0.25
    # the kernels' packed forward fragments: W0, W1 and Wt, big and small
    # (W0's also in each block's shared memory)
    assert cuda_acting_cnn.FWD_PACKED_FLOATS == 2 * (
        W0.numel() + W1.numel() + Wt.numel()) == 188416
    assert cuda_acting_cnn.W0_FRAG_FLOATS == 2 * W0.numel() == 8192


def _jax_env(horizon):
    env = drone_tpu.DroneEnv()
    return env, env.params.replace(horizon=jnp.int32(horizon))


@pytest.mark.parametrize("stochastic", [False, True])
def test_plain_cnn_traj_matches_reference(stochastic):
    """K9's plain version against traj_cnn_rollout_reference: the 21 planes
    and the final state, with episodes ending on the way."""
    _, params, model = _weights()
    N, T = 256, 8
    env, p = _jax_env(6)
    geom = PAC.CnnGeom(8, 2, 2)
    final, traj, want = jax.jit(
        lambda s, pp, prm: PAC.traj_cnn_rollout_reference(
            s, prm, pp, env.statics, T, geom=geom, stochastic=stochastic)
    )(env.init_batch(3, N), p, params)
    tenv_ = tenv.DroneEnv(device="cpu")
    launches = traj_cnn_rollout_cuda.launches
    got_final, planes, got = traj_cnn_rollout_cuda(
        tenv_.init_batch(3, N), model.flatten_(), model.arch,
        default_params("hover", horizon=6), tenv_.statics, T, stochastic)
    assert traj_cnn_rollout_cuda.launches == launches  # CPU: no kernel
    want_planes = np.asarray(pack_traj_planes(traj, N // 128))
    _close(planes, want_planes.reshape(T, -1, N), "planes")
    _close(got_final.pos, final.pos, "pos")
    assert float(got["episodes"]) == float(want["episodes"]) > 0


def test_plain_cnn_acting_matches_reference():
    """K11's plain version against the deterministic mirror over 12 steps
    (two resets a lane): the final state, the episode statistics."""
    _, params, model = _weights()
    N, T = 256, 12
    env, p = _jax_env(6)
    geom = PAC.CnnGeom(8, 2, 2)
    final, _, want = jax.jit(
        lambda s, pp, prm: PAC.traj_cnn_rollout_reference(
            s, prm, pp, env.statics, T, geom=geom, stochastic=False)
    )(env.init_batch(7, N), p, params)
    tenv_ = tenv.DroneEnv(device="cpu")
    launches = cnn_act_rollout_cuda.launches
    got_final, got = cnn_act_rollout_cuda(
        tenv_.init_batch(7, N), model.flatten_(), model.arch,
        default_params("hover", horizon=6), tenv_.statics, T)
    assert cnn_act_rollout_cuda.launches == launches
    _close(got_final.vel, final.vel, "vel")
    _close(got_final.quat, final.quat, "quat")
    assert float(got["episodes"]) == float(want["episodes"]) >= 2 * N
    for k in ("reward_sum", "ep_return_sum", "ep_length_sum"):
        _close(float(got[k]), float(want[k]), k)
    # stochastic, K11 draws K9's noise: the same final state
    sto, sto_stats = cnn_act_rollout_cuda(
        tenv_.init_batch(7, N), model.flat, model.arch,
        default_params("hover", horizon=6), tenv_.statics, T, True)
    traj_final, _, _ = traj_cnn_rollout_cuda(
        tenv_.init_batch(7, N), model.flat, model.arch,
        default_params("hover", horizon=6), tenv_.statics, T)
    assert torch.equal(sto.fstate(), traj_final.fstate())
    assert float(sto_stats["reward_sum"]) != float(got["reward_sum"])


def test_cnn_kernels_refuse_cpu_tensors_and_other_shapes():
    model = PatchCNNActorCritic(**SMALL)
    env = tenv.DroneEnv(device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_acting_cnn.cnn_act_rollout_kernel(
            env.init_batch(0, 128), model.flatten_(), model.arch, env.params,
            env.statics, 2)
    with pytest.raises(ValueError, match="PatchCNNActorCritic defaults"):
        cuda_acting_cnn.check_envelope(model.arch)
    cuda_acting_cnn.check_envelope(PatchCNNActorCritic().arch)


def test_evaluate_cnn_matches_jax():
    """The port serves every deterministic CNN evaluate through K11 (its
    plain version here; on the card cli eval's 64 lanes are one ragged
    tile); the reference serves 64 lanes through its module rollout."""
    episodes = 64
    overrides = ["env.params.horizon=12", "run.policy=cnn"]
    jcfg = JaxConfig.from_toml(HOVER).with_overrides(overrides)
    cfg = Config.from_toml(HOVER).with_overrides(overrides)
    _, params, model = _weights({})
    want = jtrain.evaluate(jcfg, runner=types.SimpleNamespace(params=params),
                           episodes=episodes)
    got = train.evaluate(cfg, runner=types.SimpleNamespace(params=model),
                         episodes=episodes, device="cpu")
    assert got["episodes"] == want["episodes"] >= episodes
    for key in ("ep_return_mean", "ep_length_mean"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)


def test_stochastic_cnn_evaluate_and_cli_eval(tmp_path, capsys):
    cfg = Config.from_toml(HOVER).with_overrides(["env.params.horizon=10",
                                                  "run.policy=cnn"])
    model = PatchCNNActorCritic(generator=torch.Generator().manual_seed(0))
    stats = train.evaluate(cfg, runner=types.SimpleNamespace(params=model),
                           episodes=32, deterministic=False, device="cpu")
    assert stats["episodes"] >= 32 and np.isfinite(stats["ep_return_mean"])
    # cli eval restores the policy from a checkpoint and serves its 64 lanes
    Checkpointer(tmp_path).save(1, model)
    assert cli.main(["eval", str(HOVER), "--device", "cpu", "run.policy=cnn",
                     f"run.resume_from={tmp_path}",
                     "env.params.horizon=8"]) == 0
    assert "episodes" in capsys.readouterr().out


def test_pixel_actor_critic_parameters_are_refused_with_the_rename(tmp_path):
    """Parameters of the overlapping-conv PixelActorCritic (a `cnn`
    submodule, no conv0) under run.policy=cnn fail with the rename, as the
    reference's _check_cnn_checkpoint_layout does."""
    pm = PixelActorCritic()
    params = jax.tree_util.tree_map(np.asarray, pm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 13), jnp.float32)))
    with pytest.raises(RuntimeError, match="run.policy=cnn_overlap"):
        params_from_flax(params)
    sd = {"cnn.conv0.weight": torch.zeros(16, 100), "log_std": torch.zeros(4)}
    Checkpointer(tmp_path).save(1, sd)
    cfg = Config.from_toml(HOVER).with_overrides([
        "run.policy=cnn", f"run.resume_from={tmp_path}"])
    with pytest.raises(RuntimeError, match="run.policy=cnn_overlap"):
        train.evaluate(cfg, device="cpu")
