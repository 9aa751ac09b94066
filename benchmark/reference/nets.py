"""Plain reference of the policies: the MLP and LSTM actor-critics as
functions of a parameter dict under the program's state-dict names.

Every product goes through `linear`, which computes in float32 with TF32
off ("fp32"), or, for the control, with its operands rounded to TF32's 10
mantissa bits and summed in float32 ("tf32"): the precision a tensor core's
single TF32 pass gives, the step below the configuration's float32.
"""

from __future__ import annotations

import torch

GATES = ("i", "f", "g", "o")


def fp32_products():
    """Full float32 products on the card: no TF32 in matmuls or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest on TF32's 10 mantissa bits (ties away from 0)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return bits.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    """x W^T with every product's operands rounded to TF32, the backward's
    (dY W and dY^T x) too: what a single TF32 pass of the tensor cores
    computes, forward and backward."""

    @staticmethod
    def forward(ctx, x, w):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.t()

    @staticmethod
    def backward(ctx, dy):
        xr, wr = ctx.saved_tensors
        dyr = round_tf32(dy)
        return dyr @ wr, dyr.t() @ xr


def linear(x, w, b=None, prec: str = "fp32"):
    """x W^T (+ b) in `prec`."""
    if prec == "tf32":
        y = _TF32Product.apply(x, w)
    elif prec == "fp32":
        y = x @ w.t()
    else:
        raise ValueError(f"prec must be 'fp32' or 'tf32', got {prec!r}")
    return y if b is None else y + b


def tower(x, p, names, prec):
    """tanh hidden layers, linear head."""
    for name in names[:-1]:
        x = torch.tanh(linear(x, p[f"{name}.weight"], p[f"{name}.bias"], prec))
    return linear(x, p[f"{names[-1]}.weight"], p[f"{names[-1]}.bias"], prec)


class MLP:
    """The MLP ActorCritic: separate actor and critic tanh towers."""

    recurrent = False

    def __init__(self, p: dict, hidden, prec: str = "fp32"):
        self.p, self.prec = p, prec
        n = len(hidden)
        self.actor_names = [f"actor_h{i}" for i in range(n)] + ["actor_mean"]
        self.critic_names = [f"critic_h{i}" for i in range(n)] + ["critic_value"]

    def initial_carry(self, n, device):
        return ()

    def mean(self, obs, carry=()):
        return tower(obs, self.p, self.actor_names, self.prec), carry

    def forward(self, obs, carry=()):
        """(mean, value, carry') at obs."""
        m = tower(obs, self.p, self.actor_names, self.prec)
        v = tower(obs, self.p, self.critic_names, self.prec)[:, 0]
        return m, v, carry

    def log_std(self):
        return self.p["log_std"]


class LSTM:
    """The LSTMActorCritic: a tanh dense encoder, one LSTM cell (flax's
    OptimizedLSTMCell: input kernels without bias, recurrent ones with),
    action and value heads on h'. The carry is (c, h)."""

    recurrent = True

    def __init__(self, p: dict, hidden: int, encoder, prec: str = "fp32"):
        self.p, self.prec, self.hidden = p, prec, int(hidden)
        self.enc = [f"enc_h{i}" for i in range(len(encoder))]

    def initial_carry(self, n, device):
        z = torch.zeros(n, self.hidden, device=device)
        return (z, z.clone())

    def _cell(self, obs, carry):
        p, prec = self.p, self.prec
        x = obs
        for name in self.enc:
            x = torch.tanh(linear(x, p[f"{name}.weight"], p[f"{name}.bias"],
                                  prec))
        c, h = carry
        pre = [linear(x, p[f"lstm.i{g}.weight"], None, prec)
               + linear(h, p[f"lstm.h{g}.weight"], None, prec)
               + p[f"lstm.h{g}.bias"] for g in GATES]
        i, f, o = (torch.sigmoid(pre[k]) for k in (0, 1, 3))
        g = torch.tanh(pre[2])
        c2 = f * c + i * g
        return c2, o * torch.tanh(c2)

    def mean(self, obs, carry):
        c2, h2 = self._cell(obs, carry)
        p = self.p
        return (linear(h2, p["actor_mean.weight"], p["actor_mean.bias"],
                       self.prec), (c2, h2))

    def forward(self, obs, carry):
        c2, h2 = self._cell(obs, carry)
        p = self.p
        m = linear(h2, p["actor_mean.weight"], p["actor_mean.bias"], self.prec)
        v = linear(h2, p["critic_value.weight"], p["critic_value.bias"],
                   self.prec)[:, 0]
        return m, v, (c2, h2)

    def log_std(self):
        return self.p["log_std"]


def make(run: dict, p: dict, prec: str = "fp32"):
    """The policy of a config's [run] table over parameters p."""
    policy = run.get("policy", "mlp")
    hidden = run.get("hidden", [64, 64])
    if policy == "mlp":
        return MLP(p, hidden, prec)
    if policy == "lstm":
        # the encoder is run.hidden[:1], as the program builds it
        return LSTM(p, run.get("lstm_hidden", 128), list(hidden)[:1], prec)
    raise ValueError(f"the reference holds the mlp and lstm policies, "
                     f"got {policy!r}")


def mask(carry, done):
    """Zero the carry of lanes whose episode ended."""
    keep = (~done).to(torch.float32)[:, None]
    return tuple(t * keep for t in carry)


def param_shapes(run: dict) -> dict:
    """{state-dict name: shape} of the policy of a [run] table, in the
    program's flat order."""
    policy = run.get("policy", "mlp")
    hidden = [int(h) for h in run.get("hidden", [64, 64])]
    shapes = {}
    if policy == "mlp":
        for tower, head, n_out in (("actor", "actor_mean", 4),
                                   ("critic", "critic_value", 1)):
            fan = 13
            for i, h in enumerate(hidden):
                shapes[f"{tower}_h{i}.weight"] = (h, fan)
                shapes[f"{tower}_h{i}.bias"] = (h,)
                fan = h
            shapes[f"{head}.weight"] = (n_out, fan)
            shapes[f"{head}.bias"] = (n_out,)
    elif policy == "lstm":
        H = int(run.get("lstm_hidden", 128))
        fan = 13
        for i, e in enumerate(hidden[:1]):
            shapes[f"enc_h{i}.weight"] = (e, fan)
            shapes[f"enc_h{i}.bias"] = (e,)
            fan = e
        for g in GATES:
            shapes[f"lstm.i{g}.weight"] = (H, fan)
        for g in GATES:
            shapes[f"lstm.h{g}.weight"] = (H, H)
        for g in GATES:
            shapes[f"lstm.h{g}.bias"] = (H,)
        shapes.update({"actor_mean.weight": (4, H), "actor_mean.bias": (4,),
                       "critic_value.weight": (1, H),
                       "critic_value.bias": (1,)})
    else:
        raise ValueError(f"the reference holds the mlp and lstm policies, "
                         f"got {policy!r}")
    shapes["log_std"] = (4,)
    return shapes
