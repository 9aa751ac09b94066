"""Patch-CNN actor-critic: the pixel policy family (counterpart of
`drone_tpu/models/cnn.py` `PatchCNNActorCritic` and `patch_cnn_trunk`).

13-float obs -> rendered res x res x 4 splat image (`pixels.obs_to_pixels`)
-> conv0 p0 x p0 / stride p0 -> relu -> conv1 p1 x p1 / stride p1 -> relu ->
flatten -> trunk (relu) -> Gaussian head (`actor_mean`, state-independent
`log_std`) and value head (`critic_value`). Both convolutions have kernel
== stride, so each is a reshape into patches and one `F.linear`.

The parameters are stored in the layout the kernels read, not torch's conv
layout (the reference's `cnn_all_weights`):

  - conv0.weight (c0, C * p0^2), rows channel-major: column c * p0^2 + di *
    p0 + dj (an `nn.Conv2d(C, c0, p0, p0)` weight flattened);
  - conv1.weight (c1, p1^2 * c0), columns (di, dj, cin) - not torch's
    (cin, di, dj);
  - trunk.weight (hidden, n_q1 * c1), columns the NHWC flatten (q, channel);
  - the heads as nn.Linear weights (out, hidden).

The trainer keeps every parameter in one flat float32 buffer
(`PatchCNNActorCritic.flatten_`) in the reference's `cnn_kernel_tensors`
order: W0, b0, W1, b1, Wt, bt, head W, head b, value W, value b, log_std.
Initialisation draws from flax's distributions (lecun-normal conv and dense
kernels, orthogonal(0.01) mean head, orthogonal(1.0) value head, zero
biases, log_std 0) from the caller's CPU generator; the bits differ from
JAX's. `params_from_flax` / `params_to_flax` carry weights across, and
`fused_opt_state_to_flax` the reference's fused optimizer state.

`CNNActorCritic` and `PixelActorCritic` are the reference's
overlapping-conv family (run.policy=cnn_overlap, the scan trainer only):
`nn.Conv2d` layers with flax's VALID padding on the NCHW view of the
reference's NHWC image, the activations turned back to NHWC before the
trunk so its rows follow flax's (h, w, c) flatten. Their flat order is the
module's own (`models.mlp.module_order`); `conv_params_from_flax` /
`conv_params_to_flax` carry weights across (flax HWIO kernels, torch
OIHW).

`PatchCNNEncoder` is the tower alone (obs -> trunk features), the module
form of `patch_cnn_trunk` (the reference's `PatchCNNEncoder`); the
pixel-recurrent `models.lstm.CNNLSTMActorCritic` builds the same tower with
`add_patch_cnn_tower` and converts it with `tower_from_flax` /
`tower_to_flax`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from drone_tpu_torch.models.mlp import (
    _lecun_normal_,
    flatten_params_,
    module_order,
    order_offsets,
    split_to_flax,
)
from drone_tpu_torch.pixels import obs_to_pixels
from drone_tpu_torch.types import ACT_DIM

N_CHAN = 4  # splat image channels (pixels.obs_to_pixels)

_RENAME = ("this checkpoint holds a PixelActorCritic (overlapping-conv) "
           "tower, but run.policy='cnn' builds the megakernel-trainable "
           "PatchCNNActorCritic architecture. Evaluate/resume it with "
           "run.policy=cnn_overlap")


class CnnGeom:
    """Static patch geometry: res the image side, p0 / p1 the conv kernels
    (== strides); g0 = res // p0 conv0 patches a side (n_q0 = g0^2), g1 =
    g0 // p1 conv1 windows a side (n_q1 = g1^2)."""

    def __init__(self, res: int, p0: int, p1: int):
        if p0 <= 0 or p1 <= 0 or res % p0 or (res // p0) % p1:
            raise ValueError(f"res {res} must split into p0 x p1 patches, "
                             f"got p0 {p0}, p1 {p1}")
        self.res, self.p0, self.p1 = res, p0, p1
        self.g0 = res // p0
        self.n_q0 = self.g0 * self.g0
        self.g1 = self.g0 // p1
        self.n_q1 = self.g1 * self.g1
        self.key = (res, p0, p1)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, CnnGeom) and self.key == other.key


class CnnArch(NamedTuple):
    """Everything that fixes the flat buffer's shapes."""

    res: int = 24
    p0: int = 4
    p1: int = 2
    c0: int = 64
    c1: int = 64
    hidden: int = 128

    @property
    def geom(self) -> CnnGeom:
        return CnnGeom(self.res, self.p0, self.p1)


def cnn_kernel_order(arch: CnnArch):
    """(state-dict name, shape) of every parameter in the reference's
    `cnn_kernel_tensors` order (its (out, 1) biases and (1, 4) log_std hold
    the same numbers as (out,) and (4,) here)."""
    g = arch.geom
    return [("conv0.weight", (arch.c0, N_CHAN * g.p0 * g.p0)),
            ("conv0.bias", (arch.c0,)),
            ("conv1.weight", (arch.c1, g.p1 * g.p1 * arch.c0)),
            ("conv1.bias", (arch.c1,)),
            ("trunk.weight", (arch.hidden, g.n_q1 * arch.c1)),
            ("trunk.bias", (arch.hidden,)),
            ("actor_mean.weight", (ACT_DIM, arch.hidden)),
            ("actor_mean.bias", (ACT_DIM,)),
            ("critic_value.weight", (1, arch.hidden)),
            ("critic_value.bias", (1,)),
            ("log_std", (ACT_DIM,))]


def cnn_kernel_offsets(arch: CnnArch):
    """({state-dict name: offset in the flat buffer}, buffer length)."""
    return order_offsets(cnn_kernel_order(arch))


def cnn_all_weights(theta: torch.Tensor, arch: CnnArch):
    """Views of the flat buffer: (W0, b0, W1, b1, Wt, bt, (head W, head b),
    (value W, value b), log_std), biases (out,)."""
    order = cnn_kernel_order(arch)
    offs, total = order_offsets(order)
    if theta.shape != (total,):
        raise ValueError(f"flat CNN parameters of {arch} have {total} floats, "
                         f"got shape {tuple(theta.shape)}")
    v = [theta[offs[name]:offs[name] + math.prod(shape)].view(shape)
         for name, shape in order]
    return (*v[:6], (v[6], v[7]), (v[8], v[9]), v[10])


def patch_cnn_trunk(obs, enc_weights, arch: CnnArch):
    """The patchify-CNN feature tower on images: obs (N, 13) -> render ->
    conv0 -> conv1 -> trunk features (N, hidden), as flax convolves the
    image."""
    W0, b0, W1, b1, Wt, bt = enc_weights
    g = arch.geom
    n = obs.shape[0]
    img = obs_to_pixels(obs, g.res)                      # (N, res, res, C)
    x = img.reshape(n, g.g0, g.p0, g.g0, g.p0, N_CHAN)
    x = x.permute(0, 1, 3, 5, 2, 4).reshape(n, g.n_q0, -1)  # (c, di, dj)
    y0 = torch.relu(F.linear(x, W0, b0))                 # (N, n_q0, c0)
    y0 = y0.reshape(n, g.g1, g.p1, g.g1, g.p1, arch.c0)
    x1 = y0.permute(0, 1, 3, 2, 4, 5).reshape(n, g.n_q1, -1)  # (di, dj, c)
    y1 = torch.relu(F.linear(x1, W1, b1))                # (N, n_q1, c1)
    return torch.relu(F.linear(y1.reshape(n, -1), Wt, bt))


TOWER = ("conv0", "conv1", "trunk")


def add_patch_cnn_tower(module: nn.Module, arch: CnnArch, generator=None,
                        device=None) -> None:
    """Register conv0, conv1 and trunk on `module` as nn.Linear layers in
    the kernel layout, lecun-normal weights drawn from `generator` in that
    order, zero biases."""
    shapes = dict(cnn_kernel_order(arch))
    for name in TOWER:
        out, fan_in = shapes[f"{name}.weight"]
        lin = nn.Linear(fan_in, out, device=device)
        _lecun_normal_(lin.weight, generator)
        nn.init.zeros_(lin.bias)
        module.add_module(name, lin)


def tower_weights(module: nn.Module):
    """(W0, b0, W1, b1, Wt, bt) of a module built by add_patch_cnn_tower."""
    return tuple(p for name in TOWER
                 for p in (getattr(module, name).weight,
                           getattr(module, name).bias))


def make_arch(res=24, patch0=4, patch1=2, channels=(64, 64),
              hidden=128) -> CnnArch:
    """The CnnArch of a patch-CNN module's constructor arguments."""
    c0, c1 = (int(c) for c in channels)
    return CnnArch(int(res), int(patch0), int(patch1), c0, c1, int(hidden))


class PatchCNNEncoder(nn.Module):
    """obs (N, 13) -> trunk features (N, hidden): the patch-CNN tower alone
    (the reference's PatchCNNEncoder)."""

    def __init__(self, res: int = 24, patch0: int = 4, patch1: int = 2,
                 channels=(64, 64), hidden: int = 128,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.arch = make_arch(res, patch0, patch1, channels, hidden)
        add_patch_cnn_tower(self, self.arch, generator, device)

    def forward(self, obs):
        return patch_cnn_trunk(obs, tower_weights(self), self.arch)


class PatchCNNActorCritic(nn.Module):
    """obs (N, 13) -> (action mean (N, 4), log_std (N, 4), value (N,))."""

    def __init__(self, res: int = 24, patch0: int = 4, patch1: int = 2,
                 channels=(64, 64), hidden: int = 128,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.arch = make_arch(res, patch0, patch1, channels, hidden)
        add_patch_cnn_tower(self, self.arch, generator, device)
        self.actor_mean = nn.Linear(self.arch.hidden, ACT_DIM, device=device)
        nn.init.orthogonal_(self.actor_mean.weight, 0.01, generator=generator)
        nn.init.zeros_(self.actor_mean.bias)
        self.critic_value = nn.Linear(self.arch.hidden, 1, device=device)
        nn.init.orthogonal_(self.critic_value.weight, 1.0, generator=generator)
        nn.init.zeros_(self.critic_value.bias)
        self.log_std = nn.Parameter(torch.zeros(ACT_DIM, device=device))

    @property
    def geom(self) -> CnnGeom:
        return self.arch.geom

    def kernel_order(self):
        return cnn_kernel_order(self.arch)

    def _concat(self) -> torch.Tensor:
        sd = dict(self.named_parameters())
        return torch.cat([sd[name].detach().reshape(-1).to(torch.float32)
                          for name, _ in self.kernel_order()])

    def flat_params(self) -> torch.Tensor:
        """The parameters in kernel order as one float32 buffer: `self.flat`
        once flattened, else a fresh concatenation."""
        flat = getattr(self, "flat", None)
        return flat if flat is not None else self._concat()

    def flatten_(self) -> torch.Tensor:
        """Move every parameter into one flat float32 buffer in kernel order
        and make the parameters views of it (ActorCritic.flatten_). Call it
        after any `.to(device)`."""
        return flatten_params_(self, self.kernel_order())

    def forward(self, obs):
        h = patch_cnn_trunk(obs, tower_weights(self), self.arch)
        mean = self.actor_mean(h)
        value = self.critic_value(h)[:, 0]
        return mean, self.log_std.expand_as(mean), value


def check_cnn_checkpoint_layout(params) -> None:
    """Refuse the parameters of the overlapping-conv PixelActorCritic (a
    `cnn` submodule and no `conv0`) where a PatchCNNActorCritic is asked
    for, with the rename (the reference's _check_cnn_checkpoint_layout).
    `params` is a flax tree or a state dict."""
    p = params["params"] if "params" in params else params
    names = {k.split(".")[0] for k in p}
    if "cnn" in names and "conv0" not in names:
        raise RuntimeError(_RENAME)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def tower_from_flax(p) -> dict[str, torch.Tensor]:
    """The conv0/conv1/trunk entries of a flax param dict -> their state-dict
    entries in the kernel layout (conv0 rows channel-major, conv1 columns
    (di, dj, cin), the trunk's NHWC flatten)."""
    k0 = np.asarray(p["conv0"]["kernel"], np.float32)    # (p0, p0, C, c0)
    k1 = np.asarray(p["conv1"]["kernel"], np.float32)    # (p1, p1, c0, c1)
    c0, c1 = k0.shape[3], k1.shape[3]
    sd = {"conv0.weight": _t(k0.transpose(2, 0, 1, 3).reshape(-1, c0).T),
          "conv1.weight": _t(k1.reshape(-1, c1).T),
          "trunk.weight": _t(np.asarray(p["trunk"]["kernel"], np.float32).T)}
    for name in TOWER:
        sd[f"{name}.bias"] = _t(p[name]["bias"])
    return sd


def tower_to_flax(sd, arch: CnnArch) -> dict:
    """tower_from_flax inverted: numpy state-dict entries -> {conv0, conv1,
    trunk} flax dicts."""
    g = arch.geom
    p = {"conv0": {"kernel": sd["conv0.weight"].T.reshape(
            N_CHAN, g.p0, g.p0, arch.c0).transpose(1, 2, 0, 3).copy()},
         "conv1": {"kernel": sd["conv1.weight"].T.reshape(
            g.p1, g.p1, arch.c0, arch.c1).copy()},
         "trunk": {"kernel": sd["trunk.weight"].T.copy()}}
    for name in TOWER:
        p[name]["bias"] = sd[f"{name}.bias"]
    return p


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax PatchCNNActorCritic variables ({"params": {...}} or the inner
    dict) -> a PatchCNNActorCritic state dict (CPU float32 tensors)."""
    check_cnn_checkpoint_layout(tree)
    p = tree["params"] if "params" in tree else tree
    sd = {**tower_from_flax(p), "log_std": _t(p["log_std"])}
    for name in ("actor_mean", "critic_value"):
        sd[f"{name}.weight"] = _t(np.asarray(p[name]["kernel"], np.float32).T)
        sd[f"{name}.bias"] = _t(p[name]["bias"])
    return sd


def params_to_flax(module: PatchCNNActorCritic) -> dict:
    """PatchCNNActorCritic -> flax variable tree {"params": {...}} of numpy
    arrays."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32)
          for k, v in module.state_dict().items()}
    p = {**tower_to_flax(sd, module.arch), "log_std": sd["log_std"]}
    for name in ("actor_mean", "critic_value"):
        p[name] = {"kernel": sd[f"{name}.weight"].T.copy(),
                   "bias": sd[f"{name}.bias"]}
    return {"params": p}


def fused_opt_state_to_flax(opt_state, arch: CnnArch):
    """(count, flat mu, flat nu) -> the reference's CNN fused state (numpy
    float32 count, [mu arrays], [nu arrays]) in its kernel-tensor shapes
    (biases (out, 1), log_std (1, 4))."""
    return split_to_flax(opt_state, cnn_kernel_order(arch))


def _conv_lecun_normal_(weight: torch.Tensor, generator=None):
    """flax's lecun-normal conv kernel: fan_in = kh * kw * cin."""
    _lecun_normal_(weight.view(weight.shape[0], -1), generator)


class CNNActorCritic(nn.Module):
    """(N, H, W, C) image -> (action mean (N, 4), log_std (N, 4), value
    (N,)): the reference's Nature-CNN-shaped actor-critic, VALID convs with
    relu, flax's (h, w, c) flatten, a relu trunk shared by the Gaussian and
    value heads. `in_shape` = (H, W, C), which flax infers at init."""

    def __init__(self, in_shape=(84, 84, 4), channels=(32, 64, 64),
                 kernels=(8, 4, 3), strides=(4, 2, 1), hidden: int = 256,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        h, w, cin = (int(d) for d in in_shape)
        self.in_shape = (h, w, cin)
        self.hidden = int(hidden)
        self.n_conv = len(channels)
        for i, (c, k, st) in enumerate(zip(channels, kernels, strides)):
            conv = nn.Conv2d(cin, int(c), int(k), int(st), device=device)
            _conv_lecun_normal_(conv.weight, generator)
            nn.init.zeros_(conv.bias)
            self.add_module(f"conv{i}", conv)
            h, w, cin = (h - k) // st + 1, (w - k) // st + 1, int(c)
        if h <= 0 or w <= 0:
            raise ValueError(f"an input of {in_shape} is smaller than the "
                             f"convolutions' windows")
        self.trunk = nn.Linear(h * w * cin, self.hidden, device=device)
        _lecun_normal_(self.trunk.weight, generator)
        nn.init.zeros_(self.trunk.bias)
        self.actor_mean = nn.Linear(self.hidden, ACT_DIM, device=device)
        nn.init.orthogonal_(self.actor_mean.weight, 0.01, generator=generator)
        nn.init.zeros_(self.actor_mean.bias)
        self.critic_value = nn.Linear(self.hidden, 1, device=device)
        nn.init.orthogonal_(self.critic_value.weight, 1.0, generator=generator)
        nn.init.zeros_(self.critic_value.bias)
        self.log_std = nn.Parameter(torch.zeros(ACT_DIM, device=device))

    def kernel_order(self):
        return module_order(self)

    def flatten_(self) -> torch.Tensor:
        """One flat float32 buffer in the module's own order, the
        parameters views of it (ActorCritic.flatten_)."""
        return flatten_params_(self, self.kernel_order())

    def forward(self, img):
        x = img.to(torch.float32).permute(0, 3, 1, 2)      # NHWC -> NCHW
        for i in range(self.n_conv):
            x = torch.relu(getattr(self, f"conv{i}")(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flax's flatten
        x = torch.relu(self.trunk(x))
        mean = self.actor_mean(x)
        value = self.critic_value(x)[:, 0]
        return mean, self.log_std.expand_as(mean), value


class PixelActorCritic(nn.Module):
    """obs (N, 13) -> rendered res x res x 4 image -> CNNActorCritic (the
    reference's PixelActorCritic, run.policy=cnn_overlap): conv 5x5/2 -> 16,
    conv 3x3/2 -> 32, trunk 128 by default, its parameters under `cnn`."""

    def __init__(self, res: int = 24, channels=(16, 32), kernels=(5, 3),
                 strides=(2, 2), hidden: int = 128,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.res = int(res)
        self.cnn = CNNActorCritic((self.res, self.res, N_CHAN), channels,
                                  kernels, strides, hidden, generator, device)

    def kernel_order(self):
        return module_order(self)

    def flatten_(self) -> torch.Tensor:
        return flatten_params_(self, self.kernel_order())

    def forward(self, obs):
        return self.cnn(obs_to_pixels(obs, self.res))


def conv_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax CNNActorCritic or PixelActorCritic variables ({"params": {...}}
    or the inner dict) -> the port's state dict: conv kernels HWIO -> OIHW,
    dense kernels (in, out) -> (out, in)."""
    p = tree["params"] if "params" in tree else tree
    sd = {}

    def walk(d, prefix):
        for name, leaf in d.items():
            if name == "log_std":
                sd[prefix + name] = _t(leaf)
            elif "kernel" in leaf:
                k = np.asarray(leaf["kernel"], np.float32)
                k = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
                sd[f"{prefix}{name}.weight"] = _t(k)
                sd[f"{prefix}{name}.bias"] = _t(leaf["bias"])
            else:
                walk(leaf, f"{prefix}{name}.")

    walk(p, "")
    return sd


def conv_params_to_flax(module: nn.Module) -> dict:
    """CNNActorCritic or PixelActorCritic -> flax variable tree {"params":
    {...}} of numpy arrays (conv_params_from_flax inverted)."""
    p = {}
    for name, t in module.state_dict().items():
        a = t.detach().cpu().numpy().astype(np.float32)
        *path, kind = name.split(".")
        leaf = p
        for key in path:
            leaf = leaf.setdefault(key, {})
        if kind == "log_std":
            leaf["log_std"] = a
        elif kind == "weight":
            leaf["kernel"] = (a.transpose(2, 3, 1, 0) if a.ndim == 4
                              else a.T).copy()
        else:
            leaf["bias"] = a
    return {"params": p}
