"""Flat-weight export for the C inference runtime (native/dronenet.c).

Counterpart of `drone_tpu/models/export.py`; the files it writes are
byte-identical to the reference's for the same weights. Format ("DRNW" v1,
little-endian):

    int32 magic 0x44524E57 ('DRNW')
    int32 version (1)
    int32 n_layers
    per layer: int32 in_dim, int32 out_dim, int32 activation
               (0=none, 1=tanh), float32 W[in*out] (row-major, W[i*out+j]),
               float32 b[out]

The exported network is the deterministic actor: obs -> encoder ->
[optional LSTM] -> action mean (log_std is not needed for deployment).

v2 adds recurrent policies: each layer is prefixed by an int32 kind
(0=dense as in v1; 1=lstm: int32 in_dim, int32 hidden, then the LSTM
kernels in gate order i,f,g,o: input kernels Wi[in*hidden] x4 (no input
bias), recurrent kernels Wh[hidden*hidden] x4, recurrent biases
bh[hidden] x4).

v3 adds the pixel-CNN policy (PatchCNNActorCritic, the patchify
configuration; overlapping-conv policies have no C runtime): kind 2 render
(int32 res, int32 n_chan=4, float32 sigma: the C runtime mirrors
pixels.obs_to_pixels) and kind 3 conv (int32 h, w, cin, patch, cout, act,
then W[patch*patch*cin*cout] in (kh, kw, cin, cout) C-order and b[cout]:
kernel == stride over a row-major HWC image). Layer kinds chain freely, so
the pixel-recurrent policy (CNNLSTMActorCritic: render + convs + trunk +
lstm + head) is also a v3 file.

The weights come from a port module or its state dict. Dense weights are
stored (out, in) and written as (in, out); the patch-CNN tower is stored in
the kernels' layout (`models.cnn`) and written in the image layout through
`cnn.tower_to_flax`.
"""

from __future__ import annotations

import ctypes
import math
import struct

import numpy as np
import torch
from torch import nn

from drone_tpu_torch.models.cnn import CnnArch, tower_to_flax
from drone_tpu_torch.pixels import SPLAT_SIGMA
from drone_tpu_torch.types import MAX_GATES, EnvParams

MAGIC = 0x44524E57
ACT_NONE = 0
ACT_TANH = 1
ACT_RELU = 2
KIND_DENSE = 0
KIND_LSTM = 1
KIND_RENDER = 2
KIND_CONV = 3
N_CHAN = 4  # render channels (pixels.obs_to_pixels)
_GATES = ("i", "f", "g", "o")  # LSTM gate order
PARAMS_MAGIC = 0x44524E50  # 'DRNP': the env params file of native/demo.c
PARAMS_VERSION = 1


class CParams(ctypes.Structure):
    """Mirror of DroneParams in oracle/drone_oracle.h (field order is the
    wire format of the `.params` file)."""

    _fields_ = [
        ("mass", ctypes.c_float),
        ("gravity", ctypes.c_float),
        ("arm_l", ctypes.c_float),
        ("thrust_max", ctypes.c_float),
        ("torque_coef", ctypes.c_float),
        ("inertia_x", ctypes.c_float),
        ("inertia_y", ctypes.c_float),
        ("inertia_z", ctypes.c_float),
        ("drag_lin", ctypes.c_float),
        ("drag_ang", ctypes.c_float),
        ("dt", ctypes.c_float),
        ("target", ctypes.c_float * 3),
        ("bound", ctypes.c_float),
        ("tilt_min", ctypes.c_float),
        ("horizon", ctypes.c_int32),
        ("c_vel", ctypes.c_float),
        ("c_spin", ctypes.c_float),
        ("c_act", ctypes.c_float),
        ("crash_penalty", ctypes.c_float),
        ("reach_bonus", ctypes.c_float),
        ("reach_tol2", ctypes.c_float),
        ("pos_radius", ctypes.c_float),
        ("vel_max_init", ctypes.c_float),
        ("rot_max_init", ctypes.c_float),
        ("omega_max_init", ctypes.c_float),
        ("dr_mass_lo", ctypes.c_float),
        ("dr_mass_hi", ctypes.c_float),
        ("dr_thrust_lo", ctypes.c_float),
        ("dr_thrust_hi", ctypes.c_float),
        ("wp_box", ctypes.c_float),
        ("wp_zmin", ctypes.c_float),
        ("wp_zmax", ctypes.c_float),
        ("gates", ctypes.c_float * (MAX_GATES * 3)),
        ("n_gates", ctypes.c_int32),
    ]


def params_to_c(p: EnvParams) -> CParams:
    """EnvParams (tensors on any device) -> the C struct."""
    c = CParams()
    for name, ctype in CParams._fields_:
        v = getattr(p, name).detach().cpu().numpy()
        if name in ("target", "gates"):
            setattr(c, name, ctype(*v.astype(np.float32).reshape(-1).tolist()))
        elif name in ("horizon", "n_gates"):
            setattr(c, name, int(v))
        else:
            setattr(c, name, float(np.float32(v)))
    return c


def export_params(p: EnvParams, path: str) -> None:
    """Write the env params for the C demo (native/demo.c): a versioned
    header (magic, version, struct size) so that a stale file is never
    reinterpreted if DroneParams grows, then the struct's bytes."""
    cstruct = params_to_c(p)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", PARAMS_MAGIC, PARAMS_VERSION,
                            ctypes.sizeof(cstruct)))
        f.write(bytes(cstruct))


def _not_patch_tower(detail: str) -> ValueError:
    return ValueError(f"CNN params are not a PatchCNNActorCritic tower "
                      f"({detail})")


def _isqrt_exact(n: int, what: str) -> int:
    r = math.isqrt(n)
    if r * r != n:
        raise _not_patch_tower(f"{what} {n} is not a square")
    return r


def _tower_arch(sd) -> CnnArch:
    """The CnnArch that a patch-CNN tower in the kernels' layout has,
    read from its shapes (conv0 (c0, 4 p0^2), conv1 (c1, p1^2 c0), trunk
    (hidden, g1^2 c1))."""
    c0, k0 = sd["conv0.weight"].shape
    c1, k1 = sd["conv1.weight"].shape
    hidden, trunk_in = sd["trunk.weight"].shape
    if k0 % N_CHAN or k1 % c0 or trunk_in % c1:
        raise _not_patch_tower(f"conv0 {sd['conv0.weight'].shape}, conv1 "
                               f"{sd['conv1.weight'].shape}, trunk_in "
                               f"{trunk_in}")
    p0 = _isqrt_exact(k0 // N_CHAN, "conv0 patch area")
    p1 = _isqrt_exact(k1 // c0, "conv1 patch area")
    g1 = _isqrt_exact(trunk_in // c1, "trunk patch grid")
    return CnnArch(g1 * p1 * p0, p0, p1, c0, c1, hidden)


def _flax_layout(sd) -> dict:
    """A state dict -> the reference's param tree of numpy arrays: dense
    kernels (in, out), conv kernels (kh, kw, cin, cout), the patch tower
    through tower_to_flax."""
    sd = {k: (v.detach().to("cpu", torch.float32).numpy()
              if isinstance(v, torch.Tensor) else np.asarray(v, np.float32))
          for k, v in sd.items()}
    tower = {}
    if "conv0.weight" in sd and sd["conv0.weight"].ndim == 2:
        tower = tower_to_flax(sd, _tower_arch(sd))
    p = dict(tower)
    for name, a in sd.items():
        if name.split(".")[0] in tower:
            continue
        *path, kind = name.split(".")
        leaf = p
        for key in path:
            leaf = leaf.setdefault(key, {})
        if kind == "log_std":
            leaf["log_std"] = a
        elif kind == "weight":
            # an overlapping conv is (out, in, kh, kw)
            leaf["kernel"] = (a.transpose(2, 3, 1, 0) if a.ndim == 4
                              else a.T).copy()
        else:
            leaf["bias"] = a
    return p


def _model_geometry(model):
    """(res, patch0, patch1) of a patch-CNN module (its CnnArch), or None
    for a module without one."""
    arch = getattr(model, "arch", None)
    if not isinstance(arch, CnnArch):
        arch = getattr(model, "encoder", None)
    if not isinstance(arch, CnnArch):
        return None
    return arch.res, arch.p0, arch.p1


def _dense(p, name, act):
    d = p[name]
    return ("dense", np.asarray(d["kernel"], np.float32),
            np.asarray(d["bias"], np.float32), act)


def _conv_tower_layers(p, model):
    """Patch-CNN tower params -> [render, conv0, conv1, trunk-dense] layer
    list (shared by the feedforward PatchCNNActorCritic and the recurrent
    CNNLSTMActorCritic exports). Geometry is inferred from parameter shapes
    and cross-checked; when `model` is given its CnnArch is authoritative
    (strides are not recorded in params — see export_flat_weights)."""
    if "conv2" in p or "conv1" not in p:
        raise ValueError(
            "CNN params are not a PatchCNNActorCritic tower (exactly "
            "two patchify convs); overlapping-conv policies have no C "
            "runtime — conv stride isn't recorded in params, so only "
            "the known kernel==stride architecture is exportable")
    k0 = np.asarray(p["conv0"]["kernel"], np.float32)
    k1 = np.asarray(p["conv1"]["kernel"], np.float32)
    p0, c_in, c0 = k0.shape[0], k0.shape[2], k0.shape[3]
    p1, c1 = k1.shape[0], k1.shape[3]
    trunk_in = np.asarray(p["trunk"]["kernel"]).shape[0]
    if (k0.shape[1] != p0 or k1.shape[1] != p1 or c_in != N_CHAN
            or k1.shape[2] != c0 or trunk_in % c1 != 0):
        raise ValueError(
            "CNN params are not a PatchCNNActorCritic tower "
            f"(conv0 {k0.shape}, conv1 {k1.shape}, trunk_in {trunk_in})")
    g1 = int(round((trunk_in // c1) ** 0.5))
    if g1 * g1 * c1 != trunk_in:
        raise ValueError(
            f"trunk input {trunk_in} is not a square patch grid x {c1} "
            "channels; only kernel==stride (patchify) CNNs have a C "
            "runtime")
    g0 = g1 * p1
    res = g0 * p0
    if model is not None:
        # geometry from the model itself, not shape inference: conv
        # STRIDES are not recorded in params, so an overlapping-conv
        # tower can pass every shape cross-check above while computing
        # a different function than the exported patchify network
        geometry = _model_geometry(model)
        if geometry is None:
            raise ValueError(
                f"model {type(model).__name__} has no patch geometry "
                "(res/patch0/patch1): only kernel==stride "
                "(PatchCNNActorCritic-family) policies have a C "
                "runtime — overlapping-conv towers are not exportable")
        if geometry != (res, p0, p1):
            m_res, m_p0, m_p1 = geometry
            raise ValueError(
                f"model geometry (res={m_res}, patch0={m_p0}, "
                f"patch1={m_p1}) disagrees with the parameter shapes "
                f"(inferred res={res}, p0={p0}, p1={p1}); params do "
                "not belong to this model")
    return [
        ("render", res, N_CHAN, float(SPLAT_SIGMA)),
        ("conv", res, res, N_CHAN, p0, c0, ACT_RELU,
         k0.reshape(-1, c0), np.asarray(p["conv0"]["bias"], np.float32)),
        ("conv", g0, g0, c0, p1, c1, ACT_RELU,
         k1.reshape(-1, c1), np.asarray(p["conv1"]["bias"], np.float32)),
        _dense(p, "trunk", ACT_RELU),
    ]


def _lstm_layer(p):
    lp = p["lstm"]
    wi = [np.asarray(lp[f"i{g}"]["kernel"], np.float32) for g in _GATES]
    wh = [np.asarray(lp[f"h{g}"]["kernel"], np.float32) for g in _GATES]
    bh = [np.asarray(lp[f"h{g}"]["bias"], np.float32) for g in _GATES]
    return ("lstm", wi, wh, bh)


def export_flat_weights(params, path: str, hidden=None, model=None) -> None:
    """Export the actor tower of a port policy to `path`.

    `params` is the module (ActorCritic, LSTMActorCritic,
    PatchCNNActorCritic, CNNLSTMActorCritic) or its state dict. MLP ->
    DRNW v1; LSTM -> DRNW v2 (detected by the presence of the `lstm`
    layers); patch-CNN and CNN-LSTM -> DRNW v3. The tower depth is probed
    from the params themselves (`hidden` is accepted for compatibility and
    ignored: a caller-supplied depth that understated the trained depth
    would export a truncated network, since equal-width layers still chain
    without a shape error).

    `model`: the module the params belong to, when the caller has it (a
    module passed as `params` is its own model). For conv towers the
    render/patch geometry is then taken FROM THE MODEL (its CnnArch)
    instead of being inferred from parameter shapes, which can
    false-accept an overlapping-conv tower whose strides happen to satisfy
    the cross-checks (strides aren't recorded in params). A model without
    patch geometry (CNNActorCritic / PixelActorCritic) is rejected with the
    real reason rather than by luck of the shape checks.
    """
    del hidden
    if isinstance(params, nn.Module):
        model = params if model is None else model
        params = params.state_dict()
    p = _flax_layout(params)
    layers = []
    if "lstm" in p and "conv0" in p:
        # CNNLSTMActorCritic (pixel-recurrent): render + patchify convs +
        # relu trunk + LSTM + actor head -> DRNW v3 (the C runtime chains
        # layer kinds freely; the LSTM layer carries the recurrent state)
        layers += _conv_tower_layers(p, model)
        layers.append(_lstm_layer(p))
        layers.append(_dense(p, "actor_mean", ACT_NONE))
        version = 3
    elif "lstm" in p:
        i = 0
        while f"enc_h{i}" in p:
            layers.append(_dense(p, f"enc_h{i}", ACT_TANH))
            i += 1
        layers.append(_lstm_layer(p))
        layers.append(_dense(p, "actor_mean", ACT_NONE))
        version = 2
    elif "conv0" in p:
        # PatchCNNActorCritic: render + two patchify convs + relu trunk.
        # Geometry is inferred from the kernels and cross-checked against
        # the trunk input size; an overlapping-conv CNNActorCritic (whose
        # stride != kernel isn't recorded in the params) fails the check
        # instead of silently exporting a wrong network.
        layers += _conv_tower_layers(p, model)
        layers.append(_dense(p, "actor_mean", ACT_NONE))
        version = 3
    else:
        if "actor_h0" not in p:
            raise ValueError(
                "params are not an exportable ActorCritic/LSTMActorCritic/"
                f"PatchCNNActorCritic tower (found {sorted(p)}); "
                "overlapping-conv CNN policies have no C runtime"
            )
        i = 0
        while f"actor_h{i}" in p:
            layers.append(_dense(p, f"actor_h{i}", ACT_TANH))
            i += 1
        layers.append(_dense(p, "actor_mean", ACT_NONE))
        version = 1

    with open(path, "wb") as f:
        f.write(struct.pack("<iii", MAGIC, version, len(layers)))
        for layer in layers:
            if layer[0] == "dense":
                _, w, b, act = layer
                if version >= 2:
                    f.write(struct.pack("<i", KIND_DENSE))
                in_dim, out_dim = w.shape
                f.write(struct.pack("<iii", in_dim, out_dim, act))
                f.write(w.astype("<f4").tobytes(order="C"))
                f.write(b.astype("<f4").tobytes(order="C"))
            elif layer[0] == "lstm":
                _, wi, wh, bh = layer
                in_dim, hid = wi[0].shape
                f.write(struct.pack("<iii", KIND_LSTM, in_dim, hid))
                for m in wi:
                    f.write(m.astype("<f4").tobytes(order="C"))
                for m in wh:
                    f.write(m.astype("<f4").tobytes(order="C"))
                for v in bh:
                    f.write(v.astype("<f4").tobytes(order="C"))
            elif layer[0] == "render":
                _, res, n_chan, sigma = layer
                f.write(struct.pack("<iiif", KIND_RENDER, res, n_chan,
                                    sigma))
            else:
                _, h, wdt, cin, patch, cout, act, w, b = layer
                f.write(struct.pack("<iiiiiii", KIND_CONV, h, wdt, cin,
                                    patch, cout, act))
                f.write(w.astype("<f4").tobytes(order="C"))
                f.write(b.astype("<f4").tobytes(order="C"))


def load_flat_weights(path: str):
    """Read a DRNW file back into a layer list: ('dense', W, b, act),
    ('lstm', wi[4], wh[4], bh[4]), ('render', res, n_chan, sigma) and
    ('conv', h, w, cin, patch, cout, act, W, b) entries."""
    layers = []
    with open(path, "rb") as f:
        magic, version, n = struct.unpack("<iii", f.read(12))
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic:#x}")
        if version not in (1, 2, 3):
            raise ValueError(f"unsupported version {version}")

        def floats(shape):
            count = int(np.prod(shape))
            return np.frombuffer(f.read(4 * count), "<f4").reshape(shape)

        for _ in range(n):
            kind = KIND_DENSE
            if version >= 2:
                (kind,) = struct.unpack("<i", f.read(4))
            if kind == KIND_DENSE:
                in_dim, out_dim, act = struct.unpack("<iii", f.read(12))
                layers.append(("dense", floats((in_dim, out_dim)),
                               floats((out_dim,)), act))
            elif kind == KIND_LSTM:
                in_dim, hid = struct.unpack("<ii", f.read(8))
                wi = [floats((in_dim, hid)) for _ in _GATES]
                wh = [floats((hid, hid)) for _ in _GATES]
                bh = [floats((hid,)) for _ in _GATES]
                layers.append(("lstm", wi, wh, bh))
            elif kind == KIND_RENDER:
                res, n_chan, sigma = struct.unpack("<iif", f.read(12))
                layers.append(("render", res, n_chan, sigma))
            elif kind == KIND_CONV:
                h, wdt, cin, patch, cout, act = struct.unpack(
                    "<iiiiii", f.read(24))
                layers.append(("conv", h, wdt, cin, patch, cout, act,
                               floats((patch * patch * cin, cout)),
                               floats((cout,))))
            else:
                raise ValueError(f"unknown layer kind {kind}")
    return layers
