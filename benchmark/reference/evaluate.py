"""Plain reference of a policy's evaluation: `episodes` lanes from episode
0 under the seed, horizon + 1 deterministic steps (the action is the
policy's mean), and the statistics of every episode that ended."""

from __future__ import annotations

import torch

from benchmark.reference import env as E
from benchmark.reference import nets


@torch.no_grad()
def evaluate(cfg: dict, params: dict, seed: int, episodes: int, device,
             prec: str = "fp32", lanes: bool = False):
    """{"episodes", "ep_return_mean", "ep_return_std", "ep_length_mean"}
    of the env seeded with `seed`, as the program's evaluate() reports
    them; with lanes=True also each lane's sums (4, N) of episodes ended,
    their returns, squared returns and lengths, and its final state."""
    p = E.params(cfg.get("env", {}), device)
    pol = nets.make(cfg["run"], {k: v.to(device, torch.float32)
                                 for k, v in params.items()}, prec)
    s = E.init(seed, episodes, p, device)
    carry = pol.initial_carry(episodes, device)
    acc = torch.zeros(4, episodes, dtype=torch.float64, device=device)
    for _ in range(p["horizon"] + 1):
        a, carry2 = pol.mean(E.observe(s), carry)
        s, _, done, ret, ln = E.step(s, a, p)
        carry = nets.mask(carry2, done) if pol.recurrent else carry2
        ret = ret.double()
        acc += torch.stack([done.double(), ret, ret * ret, ln.double()])
    n, rsum, rsq, lsum = (float(x) for x in acc.sum(1))
    mean = rsum / max(n, 1.0)
    stats = {"episodes": n, "ep_return_mean": mean,
             "ep_return_std": max(rsq / max(n, 1.0) - mean * mean,
                                  0.0) ** 0.5,
             "ep_length_mean": lsum / max(n, 1.0)}
    return (stats, acc, s) if lanes else stats
