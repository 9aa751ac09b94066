"""Default MLP actor-critic (Gaussian policy head + value head).

Counterpart of `drone_tpu/models/mlp.py`: separate actor and critic tanh
towers (`actor_h{i}`, `critic_h{i}`), a linear action-mean head
(`actor_mean`), a value head (`critic_value`) and a state-independent
`log_std`. Initialisation draws from the same distributions as flax's:
lecun-normal hidden kernels, orthogonal(0.01) mean head, orthogonal(1.0)
value head, zero biases (the bits differ from JAX's).

`params_from_flax` / `params_to_flax` convert between a flax variable tree
and this module's state dict. A flax `Dense.kernel` is (in, out); an
`nn.Linear.weight` is (out, in).

The megakernel trainer keeps every parameter in one flat float32 buffer
(`ActorCritic.flatten_`) in the reference's `_kernel_tensors` order: per
layer W (out, in) then b, the actor tower and head, the critic tower and
head, then log_std. The parameters stay views of that buffer, so the module
and the kernels see the same numbers. `fused_opt_state_from_flax` /
`fused_opt_state_to_flax` convert the reference's fused optimizer state
(count, mu list, nu list) to the port's (count, flat mu, flat nu) and back.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from drone_tpu_torch.types import ACT_DIM, OBS_DIM

# flax's lecun_normal is a normal truncated at 2 standard deviations, scaled
# so the truncated distribution has variance 1/fan_in
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, generator=None):
    std = math.sqrt(1.0 / weight.shape[1]) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class ActorCritic(nn.Module):
    """obs (N, 13) -> (action mean (N, 4), log_std (N, 4), value (N,))."""

    def __init__(self, hidden: Sequence[int] = (64, 64), dtype=torch.float32,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        self.hidden = tuple(int(h) for h in hidden)
        self.dtype = dtype
        for tower in ("actor", "critic"):
            fan_in = OBS_DIM
            for i, h in enumerate(self.hidden):
                lin = nn.Linear(fan_in, h, device=device)
                _lecun_normal_(lin.weight, generator)
                nn.init.zeros_(lin.bias)
                self.add_module(f"{tower}_h{i}", lin)
                fan_in = h
        self.actor_mean = nn.Linear(fan_in, ACT_DIM, device=device)
        nn.init.orthogonal_(self.actor_mean.weight, 0.01, generator=generator)
        nn.init.zeros_(self.actor_mean.bias)
        self.critic_value = nn.Linear(fan_in, 1, device=device)
        nn.init.orthogonal_(self.critic_value.weight, 1.0, generator=generator)
        nn.init.zeros_(self.critic_value.bias)
        self.log_std = nn.Parameter(torch.zeros(ACT_DIM, device=device))

    def flatten_(self) -> torch.Tensor:
        """Move every parameter into one flat float32 buffer in kernel order
        (`kernel_order`) and make the parameters views of it. Returns the
        buffer, also kept as `self.flat`. Call it after any `.to(device)`,
        which would give the parameters storage of their own again."""
        return flatten_params_(self, kernel_order(self.hidden))

    def kernel_order(self):
        return kernel_order(self.hidden)

    def hidden_layers(self, tower: str) -> list[nn.Linear]:
        return [getattr(self, f"{tower}_h{i}") for i in range(len(self.hidden))]

    def _dense(self, lin: nn.Linear, x):
        if self.dtype == torch.float32:
            return F.linear(x, lin.weight, lin.bias)
        return F.linear(x, lin.weight.to(self.dtype), lin.bias.to(self.dtype))

    def _tower(self, tower: str, head: nn.Linear, obs):
        x = obs.to(self.dtype)
        for lin in self.hidden_layers(tower):
            x = torch.tanh(self._dense(lin, x))
        return self._dense(head, x).to(torch.float32)

    def actor(self, obs):
        """The action mean alone (what acting needs)."""
        return self._tower("actor", self.actor_mean, obs)

    def forward(self, obs):
        mean = self.actor(obs)
        value = self._tower("critic", self.critic_value, obs)
        return mean, self.log_std.expand_as(mean), value[..., 0]


def kernel_order(hidden: Sequence[int]) -> list[tuple[str, tuple]]:
    """(state-dict name, shape) of every parameter, in the order of the
    reference's `ppo_pallas._kernel_tensors` (its b (out, 1) and log_std
    (1, 4) hold the same numbers as b (out,) and (4,) here)."""
    order = []
    for tower, head, n_head in (("actor", "actor_mean", ACT_DIM),
                                ("critic", "critic_value", 1)):
        fan_in = OBS_DIM
        for i, h in enumerate(hidden):
            order += [(f"{tower}_h{i}.weight", (h, fan_in)),
                      (f"{tower}_h{i}.bias", (h,))]
            fan_in = h
        order += [(f"{head}.weight", (n_head, fan_in)),
                  (f"{head}.bias", (n_head,))]
    order.append(("log_std", (ACT_DIM,)))
    return order


def module_order(module: nn.Module) -> list[tuple[str, tuple]]:
    """(state-dict name, shape) of every parameter of a module in its own
    registration order: the flat order of the families with no kernel
    layout (the overlapping-conv CNN, an LSTM over an encoder module)."""
    return [(name, tuple(p.shape)) for name, p in module.named_parameters()]


def flatten_params_(module: nn.Module, order) -> torch.Tensor:
    """Move every parameter of `module` into one flat float32 buffer in
    `order` [(name, shape)] and make the parameters views of it; returns
    the buffer, also kept as `module.flat` (ActorCritic.flatten_)."""
    sd = dict(module.named_parameters())
    with torch.no_grad():
        flat = torch.cat([sd[name].detach().reshape(-1).to(torch.float32)
                          for name, _ in order])
        off = 0
        for name, shape in order:
            n = math.prod(shape)
            sd[name].data = flat[off:off + n].view(shape)
            off += n
    module.flat = flat
    return flat


def tensor_sizes(order) -> list[int]:
    """The element counts of a kernel order [(name, shape), ...]: the
    tensors the fused optimizer sums the gradient norm over."""
    return [math.prod(shape) for _, shape in order]


def order_offsets(order) -> tuple[dict[str, int], int]:
    """({name: offset in the flat buffer}, buffer length) of a kernel order
    [(name, shape), ...]."""
    offs, off = {}, 0
    for name, shape in order:
        offs[name] = off
        off += math.prod(shape)
    return offs, off


def kernel_offsets(hidden: Sequence[int]) -> tuple[dict[str, int], int]:
    """({state-dict name: offset in the flat buffer}, buffer length)."""
    return order_offsets(kernel_order(hidden))


def fused_opt_state_from_flax(fused, device="cpu"):
    """The reference's fused optimizer state (count, [mu tensors], [nu
    tensors]), each list in `_kernel_tensors` order -> the port's (count
    0-d float32 tensor, flat mu, flat nu)."""
    count, mu, nu = fused

    def flat(ts):
        return torch.from_numpy(np.concatenate(
            [np.asarray(t, np.float32).reshape(-1) for t in ts])).to(device)

    return (torch.tensor(float(np.asarray(count)), dtype=torch.float32,
                         device=device), flat(mu), flat(nu))


def fused_opt_state_to_flax(opt_state, hidden: Sequence[int]):
    """Inverse of fused_opt_state_from_flax: (count, flat mu, flat nu) ->
    (numpy float32 count, [mu arrays], [nu arrays]) in the reference's
    kernel-tensor shapes (b as (out, 1), log_std as (1, 4))."""
    return split_to_flax(opt_state, kernel_order(hidden))


def split_to_flax(opt_state, order):
    """(count, flat mu, flat nu) -> (numpy float32 count, [mu arrays], [nu
    arrays]) split by `order` [(name, shape)], 1-D tensors as (n, 1)
    columns and log_std as (1, 4), the reference's kernel-tensor shapes."""
    count, mu, nu = opt_state

    def split(v):
        v = v.detach().cpu().numpy().astype(np.float32)
        out, off = [], 0
        for name, shape in order:
            n = math.prod(shape)
            ref_shape = ((1, ACT_DIM) if name == "log_std"
                         else (shape[0], 1) if len(shape) == 1 else shape)
            out.append(v[off:off + n].reshape(ref_shape))
            off += n
        return out

    return (np.float32(float(count)), split(mu), split(nu))


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """flax ActorCritic variables ({"params": {...}} or the inner dict, numpy
    or jax arrays) -> an ActorCritic state dict (CPU float32 tensors)."""
    p = tree["params"] if "params" in tree else tree
    sd = {}
    for name, leaf in p.items():
        if name == "log_std":
            sd["log_std"] = torch.from_numpy(np.array(leaf, np.float32))
            continue
        sd[f"{name}.weight"] = torch.from_numpy(
            np.array(leaf["kernel"], np.float32).T.copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))
    return sd


def params_to_flax(module: ActorCritic) -> dict:
    """ActorCritic -> flax variable tree {"params": {...}} of numpy arrays."""
    p = {}
    for name, t in module.state_dict().items():
        a = t.detach().cpu().numpy().astype(np.float32)
        if name == "log_std":
            p["log_std"] = a
            continue
        layer, kind = name.rsplit(".", 1)
        leaf = p.setdefault(layer, {})
        if kind == "weight":
            leaf["kernel"] = a.T.copy()
        else:
            leaf["bias"] = a
    return {"params": p}

