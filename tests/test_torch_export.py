"""drone_tpu_torch.models.export and `cli export` against the reference and
the C runtime.

The DRNW files the port writes are held byte for byte to
`drone_tpu.models.export_flat_weights` of the same flax weights, the
`.params` file to `oracle.params_to_c`, and the C forward
(`native/libdronenet.so`, through ctypes) to the port module's forward at
the reference tests' tolerances. The racing artifact loop trains through
`python -m drone_tpu_torch.cli train --device cpu`, exports, and flies the
C demo. The C sources are built by `make` in a copy of `native/` and
`oracle/`, so that no build output lands in the checkout.
"""

import ctypes
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drone_tpu.models import CNNLSTMActorCritic as FlaxCNNLSTM
from drone_tpu.models import LSTMActorCritic as FlaxLSTM
from drone_tpu.models import ActorCritic as FlaxMLP
from drone_tpu.models import PatchCNNActorCritic as FlaxPatchCNN
from drone_tpu.models import export_flat_weights as ref_export
from drone_tpu.utils.config import Config as JaxConfig
from drone_tpu_torch import cli
from drone_tpu_torch.models import (
    ActorCritic,
    CNNActorCritic,
    CNNLSTMActorCritic,
    LSTMActorCritic,
    PatchCNNActorCritic,
    PixelActorCritic,
    export_flat_weights,
    load_flat_weights,
)
from drone_tpu_torch.models import cnn as tcnn
from drone_tpu_torch.models import lstm as tlstm
from drone_tpu_torch.models import mlp as tmlp
from drone_tpu_torch.models.export import CParams, export_params
from drone_tpu_torch.types import default_params
from drone_tpu_torch.utils.checkpoint import Checkpointer
from drone_tpu_torch.utils.config import Config
from oracle.oracle import params_to_c

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """`make -C native` on a copy of native/ and oracle/: the C demo and
    libdronenet.so, built without writing into the checkout."""
    root = tmp_path_factory.mktemp("c")
    for sub in ("native", "oracle"):
        (root / sub).mkdir()
        for src in (REPO / sub).iterdir():
            if src.suffix in (".c", ".h") or src.name == "Makefile":
                shutil.copy(src, root / sub / src.name)
    subprocess.run(["make", "-C", str(root / "native")], check=True,
                   capture_output=True)
    return root / "native"


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _ctypes_net(native, path):
    """ctypes handle to libdronenet + a loaded DroneNet for `path`."""
    lib = ctypes.CDLL(str(native / "libdronenet.so"))
    net = ctypes.create_string_buffer(16 * 1024)  # > sizeof(DroneNet)
    assert lib.dronenet_load(net, str(path).encode()) == 0
    lib.dronenet_scratch_size.restype = ctypes.c_int
    return lib, net


def _c_forward(lib, net, obs, state=None):
    scratch = np.zeros(lib.dronenet_scratch_size(net), np.float32)
    out = np.zeros(4, np.float32)
    obs = np.ascontiguousarray(obs, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    st = state.ctypes.data_as(fp) if state is not None else None
    lib.dronenet_forward(net, obs.ctypes.data_as(fp),
                         out.ctypes.data_as(fp),
                         scratch.ctypes.data_as(fp), st)
    return out


def _numpy_forward(layers, obs):
    x = obs
    for _, w, b, act in layers:
        x = x @ w + b
        if act == 1:
            x = np.tanh(x)
    return x


def _unit_quat_obs(rng, n):
    obs = rng.randn(n, 13).astype(np.float32)
    obs[:, 3:7] /= np.linalg.norm(obs[:, 3:7], axis=1, keepdims=True)
    return obs


def test_weight_export_roundtrip(tmp_path):
    model = ActorCritic(hidden=(16, 16), generator=_gen(0))
    path = tmp_path / "w.drnw"
    export_flat_weights(model, str(path), hidden=(16, 16))
    layers = load_flat_weights(str(path))
    assert [l[1].shape for l in layers] == [(13, 16), (16, 16), (16, 4)]
    obs = np.random.RandomState(0).randn(5, 13).astype(np.float32)
    with torch.no_grad():
        mean, _, _ = model(torch.from_numpy(obs))
    np.testing.assert_allclose(_numpy_forward(layers, obs), mean.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_drnw_v2_roundtrip(tmp_path):
    model = LSTMActorCritic(hidden=8, encoder=(16,), generator=_gen(5))
    path = tmp_path / "w2.drnw"
    export_flat_weights(model, str(path))
    layers = load_flat_weights(str(path))
    assert [l[0] for l in layers] == ["dense", "lstm", "dense"]
    _, wi, wh, bh = layers[1]
    assert wi[0].shape == (16, 8) and wh[0].shape == (8, 8)
    assert bh[0].shape == (8,)
    np.testing.assert_array_equal(wh[2], model.lstm["hg"].weight.detach().T)


def _flax_family(family):
    """(flax variables, port state dict, port module) of one family at the
    reference tests' small widths, the same weights on both sides."""
    if family == "mlp":
        fm = FlaxMLP(hidden=(16, 16))
        fp = fm.init(jax.random.PRNGKey(3), jnp.zeros((1, 13)))
        tm, conv = ActorCritic(hidden=(16, 16)), tmlp.params_from_flax
    elif family == "lstm":
        fm = FlaxLSTM(hidden=8, encoder=(16,))
        fp = fm.init(jax.random.PRNGKey(4), jnp.zeros((1, 13)),
                     fm.initial_carry((1,)))
        tm, conv = LSTMActorCritic(hidden=8, encoder=(16,)), \
            tlstm.params_from_flax
    elif family == "cnn":
        fm = FlaxPatchCNN(res=8, patch0=2, patch1=2, channels=(8, 8),
                          hidden=16)
        fp = fm.init(jax.random.PRNGKey(5), jnp.zeros((1, 13)))
        tm = PatchCNNActorCritic(res=8, patch0=2, patch1=2, channels=(8, 8),
                                 hidden=16)
        conv = tcnn.params_from_flax
    else:
        fm = FlaxCNNLSTM(res=8, patch0=2, patch1=2, channels=(8, 8),
                         trunk_hidden=16, hidden=8)
        fp = fm.init(jax.random.PRNGKey(6), jnp.zeros((1, 13)),
                     fm.initial_carry((1,)))
        tm = CNNLSTMActorCritic(hidden=8, res=8, patch0=2, patch1=2,
                                channels=(8, 8), trunk_hidden=16)
        conv = tlstm.params_from_flax
    fp = jax.tree_util.tree_map(np.asarray, fp)
    sd = conv(fp)
    tm.load_state_dict(sd)
    return fm, fp, sd, tm


FAMILIES = ("mlp", "lstm", "cnn", "cnn_lstm")


@pytest.mark.parametrize("family", FAMILIES)
def test_drnw_bytes_equal_the_reference(family, tmp_path):
    """The same weights, carried across from flax, give the reference's
    file byte for byte: from the module, and from its state dict alone
    (the patch geometry then inferred from the shapes, as the reference
    infers it)."""
    fm, fp, sd, tm = _flax_family(family)
    ref, mod, raw = (tmp_path / f"{k}.drnw" for k in ("ref", "mod", "raw"))
    ref_export(fp, str(ref), model=fm)
    export_flat_weights(tm, str(mod))
    export_flat_weights(sd, str(raw))
    want = ref.read_bytes()
    assert mod.read_bytes() == want
    assert raw.read_bytes() == want


@pytest.mark.parametrize("family", FAMILIES)
def test_c_forward_matches_port_module(family, tmp_path, native):
    """libdronenet's forward against the port module's actor mean, at the
    reference tests' tolerances (tests/test_framework.py); the recurrent
    families over 12 steps that carry the state, reset at step 6."""
    rng = np.random.RandomState(FAMILIES.index(family) + 1)
    g = _gen(FAMILIES.index(family) + 3)
    if family == "mlp":
        model = ActorCritic(hidden=(16, 16), generator=g)
    elif family == "lstm":
        model = LSTMActorCritic(hidden=8, encoder=(16,), generator=g)
    elif family == "cnn":
        model = PatchCNNActorCritic(res=8, patch0=2, patch1=2,
                                    channels=(8, 8), hidden=16, generator=g)
    else:
        model = CNNLSTMActorCritic(hidden=8, res=8, patch0=2, patch1=2,
                                   channels=(8, 8), trunk_hidden=16,
                                   generator=g)
    path = tmp_path / "w.drnw"
    export_flat_weights(model, str(path))
    lib, net = _ctypes_net(native, path)
    recurrent = family in ("lstm", "cnn_lstm")
    obs = _unit_quat_obs(rng, 12 if recurrent else 8)
    if not recurrent:
        with torch.no_grad():
            mean, _, _ = model(torch.from_numpy(obs))
        for i in range(len(obs)):
            np.testing.assert_allclose(_c_forward(lib, net, obs[i]),
                                       mean[i].numpy(), rtol=1e-5, atol=1e-6)
        return
    atol = 2e-6 if family == "lstm" else 2e-5
    state = np.zeros(2 * 8, np.float32)  # h + c for hidden=8
    carry = model.initial_carry(1)
    for t in range(12):
        if t == 6:  # episode boundary: both sides reset their carry
            state[:] = 0.0
            carry = model.initial_carry(1)
        with torch.no_grad():
            mean, _, _, carry = model(torch.from_numpy(obs[t:t + 1]), carry)
        np.testing.assert_allclose(
            _c_forward(lib, net, obs[t], state), mean[0].numpy(),
            rtol=2e-5, atol=atol, err_msg=f"diverged at t={t}")


def test_export_rejects_overlapping_cnn(tmp_path):
    """Conv stride isn't recorded in the weights, so only the patch-CNN
    architecture (exactly two patchify convs) is exportable: the
    Nature-CNN-shaped CNNActorCritic and the pixel PixelActorCritic fail
    export, with the reference's reasons, instead of writing a wrong
    network."""
    model = CNNActorCritic(in_shape=(36, 36, 4), hidden=16, generator=_gen(7))
    with pytest.raises(ValueError, match="PatchCNN"):
        export_flat_weights(model.state_dict(), str(tmp_path / "bad.drnw"))
    with pytest.raises(ValueError, match="PatchCNN"):
        export_flat_weights(model, str(tmp_path / "bad.drnw"))
    pixel = PixelActorCritic(generator=_gen(8))
    with pytest.raises(ValueError, match="no C runtime"):
        export_flat_weights(pixel, str(tmp_path / "bad.drnw"))


def test_export_model_geometry_is_authoritative(tmp_path):
    """Shape inference can false-accept a 2-conv overlapping tower
    (channels (32, 64), kernels (8, 4), strides (4, 2) on a 36x36x4 input
    passes every shape cross-check at an inferred res of 96). With the
    model given, its geometry decides: a model without a patch CnnArch is
    refused, and so is one whose geometry disagrees."""
    model = CNNActorCritic(in_shape=(36, 36, 4), channels=(32, 64),
                           kernels=(8, 4), strides=(4, 2), hidden=16,
                           generator=_gen(9))
    with pytest.raises(ValueError, match="no patch geometry"):
        export_flat_weights(model.state_dict(), str(tmp_path / "bad2.drnw"),
                            model=model)
    with pytest.raises(ValueError, match="no patch geometry"):
        export_flat_weights(model, str(tmp_path / "bad2.drnw"))

    patch = PatchCNNActorCritic(res=8, patch0=2, patch1=2, channels=(8, 8),
                                hidden=16, generator=_gen(10))
    export_flat_weights(patch.state_dict(), str(tmp_path / "ok.drnw"),
                        model=patch)
    other = PatchCNNActorCritic(res=16, patch0=4, patch1=2, channels=(8, 8),
                                hidden=16)
    with pytest.raises(ValueError, match="disagrees"):
        export_flat_weights(patch.state_dict(), str(tmp_path / "mis.drnw"),
                            model=other)


def test_export_probes_depth_from_params(tmp_path):
    """The depth comes from the weights, not from a caller's hidden tuple
    (equal widths chain without an error, so a short hint would truncate)."""
    model = ActorCritic(hidden=(8, 8, 8), generator=_gen(6))
    path = tmp_path / "deep.drnw"
    export_flat_weights(model.state_dict(), str(path), hidden=(8,))
    layers = load_flat_weights(str(path))
    assert [l[1].shape for l in layers] == [(13, 8), (8, 8), (8, 8), (8, 4)]
    obs = np.random.RandomState(3).randn(3, 13).astype(np.float32)
    with torch.no_grad():
        mean, _, _ = model(torch.from_numpy(obs))
    np.testing.assert_allclose(_numpy_forward(layers, obs), mean.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("task", ["hover", "waypoint", "racing"])
def test_params_file_equals_the_oracle_struct(task, tmp_path):
    """`.params` = the versioned header + the bytes of oracle.params_to_c,
    for each task's config (racing.toml overrides the gate radius)."""
    path = REPO / "configs" / f"{task}.toml"
    _, jparams = JaxConfig.from_toml(path).env.build()
    _, tparams = Config.from_toml(path).env.build()
    want = params_to_c(jparams)
    out = tmp_path / "p.params"
    export_params(tparams, str(out))
    data = out.read_bytes()
    assert struct.unpack("<III", data[:12]) == (
        0x44524E50, 1, ctypes.sizeof(want))
    assert data[12:] == bytes(want)


def test_cli_export_writes_both_files(tmp_path, capsys):
    model = ActorCritic((64, 64), generator=_gen(2))
    Checkpointer(tmp_path / "ckpt").save(5, model)
    out = tmp_path / "policy.drnw"
    rc = cli.main(["export", str(REPO / "configs" / "hover.toml"),
                   f"run.resume_from={tmp_path / 'ckpt'}", "--out", str(out)])
    assert rc == 0
    assert "wrote" in capsys.readouterr().out
    export_flat_weights(model, str(tmp_path / "want.drnw"))
    assert out.read_bytes() == (tmp_path / "want.drnw").read_bytes()
    data = Path(str(out) + ".params").read_bytes()
    assert len(data) == 12 + ctypes.sizeof(CParams)


def test_racing_artifact_loop(tmp_path, native):
    """Train racing/rk4 through the CLI on the CPU -> export DRNW + params
    -> the pure-C demo flies one episode and dumps trajectory.csv, with the
    default gate circuit read back from the params file."""
    envv = dict(os.environ)
    envv["PYTHONPATH"] = str(REPO)
    run = lambda *a: subprocess.run(
        [sys.executable, "-m", "drone_tpu_torch.cli", *a],
        capture_output=True, text=True, cwd=REPO, env=envv)
    common = [
        "env.task=racing", "env.integrator=rk4",
        "run.total_updates=2", "run.log_interval=1",
        f"run.checkpoint_dir={tmp_path}", "run.run_name=racelap",
        "train.num_envs=64", "train.horizon=8", "train.epochs=1",
        "train.num_minibatches=1", "run.hidden=(16,)",
    ]
    r = run("train", *common, "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    out = str(tmp_path / "racing.drnw")
    r = run("export", *common, "--out", out)
    assert r.returncode == 0, r.stderr[-2000:]
    assert [l[1].shape for l in load_flat_weights(out)] == [(13, 16), (16, 4)]

    # C demo: 1 episode, task 2 (racing), seed 0, integrator 1 (rk4)
    r = subprocess.run(
        [str(native / "drone_demo"), out, out + ".params", "1", "2", "0", "1"],
        capture_output=True, text=True, cwd=tmp_path, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = np.loadtxt(tmp_path / "trajectory.csv", delimiter=",",
                      skiprows=1, ndmin=2)
    assert len(rows) >= 1 and np.isfinite(rows).all()
    assert rows[-1, 8] == 1  # the episode ended

    c = CParams.from_buffer_copy(Path(out + ".params").read_bytes()[12:])
    gates = np.array(c.gates, np.float32).reshape(-1, 3)[:c.n_gates]
    want = default_params("racing")
    assert c.n_gates == int(want.n_gates) == 4
    np.testing.assert_array_equal(gates, want.gates.numpy()[:4])
