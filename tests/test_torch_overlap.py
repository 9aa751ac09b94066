"""The overlapping-conv pixel family (run.policy=cnn_overlap): the port's
CNNActorCritic and PixelActorCritic against flax's on the same weights,
their converters, the scan trainer's grad_accum on it, and its training
and serving paths on the CPU.
"""

from pathlib import Path

import numpy as np
import jax
import pytest
import torch

from drone_tpu.models.cnn import CNNActorCritic as FlaxCNN
from drone_tpu.models.cnn import PixelActorCritic as FlaxPixel
from drone_tpu_torch import cli, ppo, train
from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import (
    CNNActorCritic,
    PixelActorCritic,
    conv_params_from_flax,
    conv_params_to_flax,
)
from drone_tpu_torch.models.cnn import check_cnn_checkpoint_layout
from drone_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
HOVER = ROOT / "configs" / "hover.toml"
TINY_PIXEL = dict(res=8, channels=(4, 8), kernels=(3, 3), strides=(1, 1),
                  hidden=16)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flax_tree(fmodel, model, x):
    """The port's weights as fmodel's flax tree, held to the structure and
    shapes flax's init gives (traced, not run), and converted back
    bitwise."""
    tree = conv_params_to_flax(model)
    shapes = jax.eval_shape(fmodel.init, jax.random.PRNGKey(0), x)
    assert (jax.tree_util.tree_structure(shapes)
            == jax.tree_util.tree_structure(tree))
    for a, b in zip(jax.tree_util.tree_leaves(shapes),
                    jax.tree_util.tree_leaves(tree)):
        assert a.shape == b.shape
    back = conv_params_from_flax(tree)
    for name, t in model.state_dict().items():
        assert torch.equal(back[name], t), name
    return tree


@pytest.mark.parametrize("family", ["cnn", "pixel"])
def test_overlapping_conv_models_match_flax(family):
    """NHWC input and HWIO kernels with VALID padding (flax) against the
    port's NCHW convolutions, the trunk reading flax's (h, w, c) flatten;
    log_std broadcast to the mean's shape."""
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(1)
    if family == "cnn":
        kw = dict(channels=(4, 6), kernels=(4, 3), strides=(2, 1), hidden=8)
        fmodel = FlaxCNN(**kw)
        model = CNNActorCritic((11, 9, 3), generator=gen, **kw)
        x = rng.normal(size=(5, 11, 9, 3)).astype(np.float32)
    else:
        fmodel = FlaxPixel(**TINY_PIXEL)
        model = PixelActorCritic(generator=gen, **TINY_PIXEL)
        x = rng.normal(size=(5, 13)).astype(np.float32)
    with torch.no_grad():
        model.get_parameter(
            "log_std" if family == "cnn" else "cnn.log_std").fill_(-0.3)
    tree = _flax_tree(fmodel, model, x[:1])
    want = jax.jit(fmodel.apply)(tree, x)
    got = model(torch.from_numpy(x))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
    order = [n for n, _ in model.kernel_order()]
    assert order == [n for n, _ in model.named_parameters()]
    flat = model.flatten_()
    assert flat.numel() == sum(p.numel() for p in model.parameters())
    assert model(torch.from_numpy(x))[0].shape == (5, 4)


def test_a_pixel_tree_is_refused_under_the_patch_policy():
    sd = PixelActorCritic(**TINY_PIXEL).state_dict()
    with pytest.raises(RuntimeError, match="cnn_overlap"):
        check_cnn_checkpoint_layout(sd)


def test_grad_accum_matches_full_batch_update():
    """grad_accum=4 against grad_accum=1 on PixelActorCritic, one update
    from the same runner (tests/test_pixels.py's check): the chunks' mean
    gradient is the minibatch's, up to the order of the sums."""
    env = tenv.DroneEnv(device="cpu")
    base = dict(horizon=8, num_envs=32, epochs=2, num_minibatches=2)
    runs = {}
    for ga in (1, 4):
        cfg = ppo.PPOConfig(grad_accum=ga, **base)
        model = PixelActorCritic(generator=torch.Generator().manual_seed(0),
                                 **TINY_PIXEL)
        runner = ppo.init_runner(model, env, cfg, seed=0)
        runs[ga] = ppo.make_train_step(model, env, cfg)(runner)
    (r1, m1), (r4, m4) = runs[1], runs[4]
    np.testing.assert_allclose(r1.params.flat.numpy(), r4.params.flat.numpy(),
                               rtol=2e-4, atol=2e-6)
    for a, b in zip(r1.opt_state, r4.opt_state):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-6)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="grad_accum"):
        ppo.make_train_step(model, env, ppo.PPOConfig(grad_accum=3, **base))


def _cfg(tmp_path, name, total, extra=()):
    return Config.default().with_overrides([
        "run.policy=cnn_overlap", "train.num_envs=16", "train.horizon=2",
        "train.epochs=1", "train.num_minibatches=2", "train.grad_accum=2",
        "run.log_interval=1", f"run.total_updates={total}",
        f"run.run_name={name}", f"run.checkpoint_dir={tmp_path}", *extra])


def test_cnn_overlap_resume_is_bitwise(tmp_path):
    """train(2) == train(1) + resume(1), every tensor of the runner, both
    generators' states among them."""
    full, _ = train.train(_cfg(tmp_path, "full", 2), device="cpu")
    train.train(_cfg(tmp_path, "half", 1), device="cpu")
    resumed, last = train.train(_cfg(tmp_path, "resumed", 2, [
        f"run.resume_from={tmp_path}/half/checkpoints"]), device="cpu")

    def tensors(r):
        return [*r.params.state_dict().values(), *r.opt_state,
                r.env_state.fstate(), r.env_state.step, r.generator.get_state(),
                r.noise_generator.get_state()]

    assert resumed.update_idx == full.update_idx == 2
    for a, b in zip(tensors(full), tensors(resumed)):
        assert torch.equal(a, b)
    assert np.isfinite(last["loss"])


def test_cli_train_then_eval_cnn_overlap_on_cpu(tmp_path, capsys):
    over = ["--device", "cpu", "run.policy=cnn_overlap"]
    assert cli.main(["train", str(HOVER), *over, "train.num_envs=16",
                     "train.horizon=2", "train.num_minibatches=2",
                     "train.epochs=1", "train.grad_accum=2",
                     "run.total_updates=2", f"run.checkpoint_dir={tmp_path}",
                     "run.run_name=cli"]) == 0
    capsys.readouterr()
    assert cli.main(["eval", str(HOVER), *over,
                     f"run.resume_from={tmp_path}/cli/checkpoints",
                     "env.params.horizon=6"]) == 0
    assert '"episodes"' in capsys.readouterr().out
