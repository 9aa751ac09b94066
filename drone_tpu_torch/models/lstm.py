"""LSTM actor-critic (counterpart of `drone_tpu/models/lstm.py`).

A tanh dense encoder (`enc_h{i}`), one LSTM cell with flax's
`OptimizedLSTMCell` semantics, a Gaussian action head (`actor_mean`, a
state-independent `log_std`) and a value head (`critic_value`):

    x = tanh(... tanh(obs W0^T + b0) ...)
    i = sig(x Wii^T + h Whi^T + bhi)     f = sig(x Wif^T + h Whf^T + bhf)
    g = tanh(x Wig^T + h Whg^T + bhg)    o = sig(x Wio^T + h Who^T + bho)
    c' = f * c + i * g                   h' = o * tanh(c')

The input-gate kernels `lstm.i{i,f,g,o}` have no bias; the recurrent ones
`lstm.h{i,f,g,o}` carry one. The carry is the flax tuple (c, h), cell state
first, each (N, hidden). Initialisation draws from flax's distributions
(lecun-normal encoder and input kernels, orthogonal recurrent kernels,
orthogonal(0.01) mean head, orthogonal(1.0) value head, zero biases); the
bits differ from JAX's.

The recurrent trainer keeps every parameter in one flat float32 buffer
(`LSTMActorCritic.flatten_`) in the reference's `lstm_kernel_tensors`
order (`drone_tpu/ppo_rnn_pallas.py`): per encoder layer W (out, in) then
b; the 4 input-gate kernels (H, E), the 4 recurrent kernels (H, H), the 4
recurrent biases; the action head W (4, H), b; the value head W (1, H), b;
log_std. The parameters are views of that buffer, as in `models.mlp`.
`params_from_flax` / `params_to_flax` carry weights across, and
`fused_opt_state_to_flax` the reference's fused optimizer state (count, mu
list, nu list); `models.mlp.fused_opt_state_from_flax`, a concatenation,
serves every family.

The pixel-recurrent family (`CNNLSTMActorCritic`, run.policy=cnn_lstm)
replaces the dense tower with the patch-CNN one of `models.cnn` (render,
conv0, conv1, relu trunk), inlined with the reference's flat names conv0 /
conv1 / trunk. Everywhere below, `encoder` is either the dense widths (a
tuple of ints) or the tower's `CnnArch`; `encoder_of` tells them apart.
In the flat buffer the CNN's three (W, b) pairs take the dense pairs'
place, in the kernel layouts of `models.cnn`.

`LSTMActorCritic(encoder_module=...)` is the reference's LSTM over any
obs -> features module (its LSTMWrapper-parity hook, the scan trainer
only): the module's parameters come first, under `encoder_module`, and the
flat order is the module's own (`models.mlp.module_order`). Its `encoder`
is ENCODER_MODULE, which `encoder_of` and with it every kernel's envelope
check refuses.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from drone_tpu_torch.models.cnn import (
    CnnArch,
    add_patch_cnn_tower,
    cnn_kernel_order,
    make_arch,
    patch_cnn_trunk,
    tower_from_flax,
    tower_to_flax,
    tower_weights,
)
from drone_tpu_torch.models.mlp import (
    _lecun_normal_,
    flatten_params_,
    module_order,
    order_offsets,
    split_to_flax,
)
from drone_tpu_torch.types import ACT_DIM, OBS_DIM

GATES = ("i", "f", "g", "o")
# the `encoder` of an LSTM over an encoder module: no kernel layout
ENCODER_MODULE = "encoder_module"


def encoder_of(encoder):
    """The encoder as the functions below take it: a CnnArch as it is, the
    dense widths as a tuple of ints. Raises ValueError for an encoder
    module, which no kernel takes."""
    if isinstance(encoder, CnnArch):
        return encoder
    if isinstance(encoder, str) and encoder == ENCODER_MODULE:
        raise ValueError("an LSTMActorCritic(encoder_module=...) has no "
                         "kernel layout: the LSTM kernels take the dense "
                         "enc_h* tower or the patch-CNN tower only")
    return tuple(int(e) for e in encoder)


def is_cnn(encoder) -> bool:
    return isinstance(encoder, CnnArch)


def encoder_width(encoder) -> int:
    """E, the LSTM's input width: the trunk's, the last dense layer's, or
    the observation's with no encoder."""
    if is_cnn(encoder):
        return encoder.hidden
    return encoder[-1] if encoder else OBS_DIM


def lstm_kernel_order(hidden: int, encoder):
    """(state-dict name, shape) of every parameter in the reference's
    `lstm_kernel_tensors` order (its (out, 1) biases and (1, 4) log_std
    hold the same numbers as (out,) and (4,) here)."""
    encoder = encoder_of(encoder)
    if is_cnn(encoder):
        order = cnn_kernel_order(encoder)[:6]
    else:
        order = []
        for i, e in enumerate(encoder):
            fan_in = encoder[i - 1] if i else OBS_DIM
            order += [(f"enc_h{i}.weight", (e, fan_in)),
                      (f"enc_h{i}.bias", (e,))]
    fan_in = encoder_width(encoder)
    order += [(f"lstm.i{g}.weight", (hidden, fan_in)) for g in GATES]
    order += [(f"lstm.h{g}.weight", (hidden, hidden)) for g in GATES]
    order += [(f"lstm.h{g}.bias", (hidden,)) for g in GATES]
    order += [("actor_mean.weight", (ACT_DIM, hidden)),
              ("actor_mean.bias", (ACT_DIM,)),
              ("critic_value.weight", (1, hidden)),
              ("critic_value.bias", (1,)),
              ("log_std", (ACT_DIM,))]
    return order


def lstm_kernel_offsets(hidden: int, encoder):
    """({state-dict name: offset in the flat buffer}, buffer length)."""
    return order_offsets(lstm_kernel_order(hidden, encoder))


def encoder_layers(encoder) -> list[str]:
    """The state-dict prefixes of the encoder's (W, b) pairs, in order (none
    for an encoder module)."""
    if isinstance(encoder, str) and encoder == ENCODER_MODULE:
        return []
    if is_cnn(encoder):
        return ["conv0", "conv1", "trunk"]
    return [f"enc_h{i}" for i in range(len(encoder))]


def lstm_weights(theta: torch.Tensor, hidden: int, encoder):
    """Views of the flat buffer: (enc [(W, b), ...], wi [4 x (H, E)], wh [4 x
    (H, H)], bh [4 x (H,)], head (W (4, H), b (4,)), vhead (W (1, H), b (1,)),
    log_std (4,)). enc holds the dense pairs, or the CNN's (W0, b0), (W1,
    b1), (Wt, bt)."""
    encoder = encoder_of(encoder)
    order = lstm_kernel_order(hidden, encoder)
    offs, total = lstm_kernel_offsets(hidden, encoder)
    if theta.shape != (total,):
        raise ValueError(f"flat LSTM parameters (hidden {hidden}, encoder "
                         f"{encoder}) have {total} floats, got shape "
                         f"{tuple(theta.shape)}")
    v = {name: theta[offs[name]:offs[name] + math.prod(shape)].view(shape)
         for name, shape in order}
    enc = [(v[f"{e}.weight"], v[f"{e}.bias"]) for e in encoder_layers(encoder)]
    wi = [v[f"lstm.i{g}.weight"] for g in GATES]
    wh = [v[f"lstm.h{g}.weight"] for g in GATES]
    bh = [v[f"lstm.h{g}.bias"] for g in GATES]
    return (enc, wi, wh, bh, (v["actor_mean.weight"], v["actor_mean.bias"]),
            (v["critic_value.weight"], v["critic_value.bias"]), v["log_std"])


def _operand(x, compute_dtype):
    # imported here: drone_tpu_torch.ops imports this module
    from drone_tpu_torch.ops.cuda_acting_traj import operand

    return operand(x, compute_dtype)


def dense_encode(obs, enc, compute_dtype: str = "float32"):
    """The tanh dense tower: obs (N, 13) -> activations [obs, enc_1, ...,
    x]. Under bfloat16 each layer's product takes its operands rounded to
    bfloat16 (the reference's `_dot32`); the bias adds and tanh stay
    float32."""
    acts = [obs]
    for w, b in enc:
        acts.append(torch.tanh(F.linear(_operand(acts[-1], compute_dtype),
                                        _operand(w, compute_dtype), b)))
    return acts


def gate_linear(x, h, wi, wh):
    """x Wi^T + h Wh^T, one gate's pre-activation before its bias (the
    reference's dot(wi, x) + dot(wh, h)). The acting kernels' CNN arm runs
    the four gates as one product (x; h) [Wi; Wh] in 3xTF32; an emulation
    of that (cuda_update_cnn.mm_3xtf32) can take its place."""
    return F.linear(x, wi) + F.linear(h, wh)


def lstm_step(obs, c, h, weights, encode=dense_encode,
              compute_dtype: str = "float32"):
    """One encoder + LSTM step, batch-major: obs (N, 13), c/h (N, H) ->
    (encoder activations, gates (i, f, g, o), c', tanh(c'), h').
    encode(obs, enc) gives the activations, the last of them x (the dense
    tower's [obs, enc_1, ..., x] by default; it rounds its own products).
    The gate pre-activation is (x Wi^T + h Wh^T) + b, the reference's
    dot(wi, x) + dot(wh, h) + bh; under bfloat16 x, h and the gate weights
    enter gate_linear rounded to bfloat16, and the bias, the cell and the
    activations stay float32."""
    enc, wi, wh, bh = weights[:4]
    acts = encode(obs, enc)
    x, hr = _operand(acts[-1], compute_dtype), _operand(h, compute_dtype)
    pre = [gate_linear(x, hr, _operand(wi[k], compute_dtype),
                       _operand(wh[k], compute_dtype)) + bh[k]
           for k in range(4)]
    gi, gf, go = (torch.sigmoid(pre[k]) for k in (0, 1, 3))
    gg = torch.tanh(pre[2])
    c2 = gf * c + gi * gg
    th = torch.tanh(c2)
    return acts, (gi, gf, gg, go), c2, th, go * th


class LSTMActorCritic(nn.Module):
    """obs (N, 13), carry (c, h) -> (mean (N, 4), log_std (N, 4), value (N,),
    carry'). `encoder` is the dense widths or, for the pixel-recurrent
    family, the patch-CNN tower's CnnArch (see CNNLSTMActorCritic);
    `encoder_module`, when given, replaces both (any obs -> features
    module, its output width read from a forward on one zero obs)."""

    def __init__(self, hidden: int = 128, encoder=(64,),
                 generator: torch.Generator | None = None, device=None,
                 encoder_module: nn.Module | None = None):
        super().__init__()
        self.hidden = int(hidden)
        if encoder_module is not None:
            self.encoder = ENCODER_MODULE
            self.encoder_module = encoder_module
            with torch.no_grad():
                fan_in = int(encoder_module(
                    torch.zeros(1, OBS_DIM, device=device)).shape[-1])
        else:
            self.encoder = encoder_of(encoder)
            self.encoder_module = None
            fan_in = encoder_width(self.encoder)
        if is_cnn(self.encoder):
            add_patch_cnn_tower(self, self.encoder, generator, device)
        else:
            for i, e in enumerate(encoder_layers(self.encoder)):
                lin = nn.Linear(self.encoder[i - 1] if i else OBS_DIM,
                                self.encoder[i], device=device)
                _lecun_normal_(lin.weight, generator)
                nn.init.zeros_(lin.bias)
                self.add_module(e, lin)
        self.lstm = nn.ModuleDict()
        for g in GATES:
            lin = nn.Linear(fan_in, self.hidden, bias=False, device=device)
            _lecun_normal_(lin.weight, generator)
            self.lstm[f"i{g}"] = lin
        for g in GATES:
            lin = nn.Linear(self.hidden, self.hidden, device=device)
            nn.init.orthogonal_(lin.weight, 1.0, generator=generator)
            nn.init.zeros_(lin.bias)
            self.lstm[f"h{g}"] = lin
        self.actor_mean = nn.Linear(self.hidden, ACT_DIM, device=device)
        nn.init.orthogonal_(self.actor_mean.weight, 0.01, generator=generator)
        nn.init.zeros_(self.actor_mean.bias)
        self.critic_value = nn.Linear(self.hidden, 1, device=device)
        nn.init.orthogonal_(self.critic_value.weight, 1.0, generator=generator)
        nn.init.zeros_(self.critic_value.bias)
        self.log_std = nn.Parameter(torch.zeros(ACT_DIM, device=device))

    def kernel_order(self):
        if self.encoder_module is not None:
            return module_order(self)
        return lstm_kernel_order(self.hidden, self.encoder)

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

    def initial_carry(self, n: int, device=None):
        zeros = torch.zeros(n, self.hidden, device=device)
        return (zeros, zeros.clone())

    def weights(self):
        """lstm_weights of the module's own parameters."""
        enc = [(getattr(self, e).weight, getattr(self, e).bias)
               for e in encoder_layers(self.encoder)]
        return (enc, [self.lstm[f"i{g}"].weight for g in GATES],
                [self.lstm[f"h{g}"].weight for g in GATES],
                [self.lstm[f"h{g}"].bias for g in GATES],
                (self.actor_mean.weight, self.actor_mean.bias),
                (self.critic_value.weight, self.critic_value.bias),
                self.log_std)

    def forward(self, obs, carry):
        c, h = carry
        encode = dense_encode
        if self.encoder_module is not None:
            def encode(x, enc):
                return [self.encoder_module(x)]
        elif is_cnn(self.encoder):
            def encode(x, enc):
                return [patch_cnn_trunk(x, tower_weights(self), self.encoder)]
        *_, c2, _, h2 = lstm_step(obs, c, h, self.weights(), encode)
        mean = self.actor_mean(h2)
        value = self.critic_value(h2)[:, 0]
        return mean, self.log_std.expand_as(mean), value, (c2, h2)


class CNNLSTMActorCritic(LSTMActorCritic):
    """The pixel-recurrent policy (run.policy=cnn_lstm): obs (N, 13) ->
    rendered 24x24x4 image -> patch-CNN tower (conv0, conv1, relu trunk) ->
    LSTM -> Gaussian and value heads (the reference's CNNLSTMActorCritic)."""

    def __init__(self, hidden: int = 128, res: int = 24, patch0: int = 4,
                 patch1: int = 2, channels=(64, 64), trunk_hidden: int = 128,
                 generator: torch.Generator | None = None, device=None):
        super().__init__(hidden, make_arch(res, patch0, patch1, channels,
                                           trunk_hidden),
                         generator=generator, device=device)


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax LSTMActorCritic or CNNLSTMActorCritic variables ({"params":
    {...}} or the inner dict) -> the port's state dict (CPU float32
    tensors). A conv0 tree is the pixel-recurrent family; its tower goes to
    the kernel layout as in models.cnn."""
    p = tree["params"] if "params" in tree else tree
    cnn = "conv0" in p
    known = {"lstm", "actor_mean", "critic_value", "log_std",
             *(("conv0", "conv1", "trunk") if cnn else ()),
             *(("encoder_module",) if "encoder_module" in p else ())}
    # a tree with conv1 or trunk but no conv0 is neither encoder (the
    # reference's lstm_encoder_kind lets it through as an empty dense one)
    unknown = sorted(k for k in p if k not in known
                     and (cnn or not k.startswith("enc_h")))
    if unknown:
        raise ValueError(f"unrecognized LSTM encoder params {unknown}: the "
                         f"port takes the dense enc_h* tower or the "
                         f"conv0/conv1/trunk patch-CNN tower")

    def t(a, transpose=False):
        a = np.array(a, np.float32)
        return torch.from_numpy(a.T.copy() if transpose else a)

    sd = tower_from_flax(p) if cnn else {}
    if "encoder_module" in p:
        # the patch-CNN encoder module (PatchCNNEncoder), the one encoder
        # module with a converter
        sd.update({f"encoder_module.{k}": v
                   for k, v in tower_from_flax(p["encoder_module"]).items()})
    for name, leaf in p.items():
        if name in ("conv0", "conv1", "trunk", "encoder_module"):
            continue
        if name == "log_std":
            sd["log_std"] = t(leaf)
        elif name == "lstm":
            for gate, d in leaf.items():
                sd[f"lstm.{gate}.weight"] = t(d["kernel"], True)
                if "bias" in d:
                    sd[f"lstm.{gate}.bias"] = t(d["bias"])
        else:
            sd[f"{name}.weight"] = t(leaf["kernel"], True)
            sd[f"{name}.bias"] = t(leaf["bias"])
    return sd


def params_to_flax(module: LSTMActorCritic) -> dict:
    """LSTMActorCritic or CNNLSTMActorCritic -> flax variable tree
    {"params": {...}} of numpy arrays."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32)
          for k, v in module.state_dict().items()}
    p = tower_to_flax(sd, module.encoder) if is_cnn(module.encoder) else {}
    if module.encoder_module is not None:
        pre = "encoder_module."
        p["encoder_module"] = tower_to_flax(
            {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)},
            module.encoder_module.arch)
    tower = set(p)
    for name, a in sd.items():
        if name.split(".")[0] in tower:
            continue
        if name == "log_std":
            p["log_std"] = a
            continue
        *path, kind = name.split(".")
        leaf = p
        for key in path:
            leaf = leaf.setdefault(key, {})
        if kind == "weight":
            leaf["kernel"] = a.T.copy()
        else:
            leaf["bias"] = a
    return {"params": p}


def fused_opt_state_to_flax(opt_state, hidden: int, encoder):
    """(count, flat mu, flat nu) -> the reference's recurrent fused state
    (numpy float32 count, [mu arrays], [nu arrays]) in its kernel-tensor
    shapes (biases (out, 1), log_std (1, 4))."""
    return split_to_flax(opt_state, lstm_kernel_order(hidden, encoder))
