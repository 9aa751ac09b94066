"""Plain reference of a PPO training run: the rollout with the lanes'
exploration noise, GAE, the clipped PPO loss differentiated by autograd
(truncated BPTT for a recurrent policy) and clip-by-global-norm + Adam
with the learning rate's linear anneal, as the configuration states them
(CleanRL's clipped PPO: https://github.com/vwxyzjn/cleanrl).

It follows a run from the seed: the env's lanes from `env.init`, the
weights the benchmark made, the minibatch permutations from a CPU
`torch.Generator` seeded with the run's seed, one `torch.randperm` of the
row blocks an epoch, drawn as the update starts.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import env as E
from benchmark.reference import nets

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def row_block(mb_rows: int) -> int:
    """Rows of 128 lanes a shuffled block: the largest of 8, 4, 2 dividing
    the minibatch's rows, else 1."""
    for k in (8, 4, 2):
        if mb_rows % k == 0:
            return k
    return 1


class Run:
    """The state of a reference training run: parameters, Adam's moments
    and step count, the env's lanes, the carry, the permutation
    generator. `train` is the table [train] of the configuration."""

    def __init__(self, cfg: dict, params: dict, seed: int, device,
                 prec: str = "fp32", half_batch: bool = False,
                 frozen: bool = False):
        self.run, self.train = cfg["run"], cfg["train"]
        self.envp = E.params(cfg.get("env", {}), device)
        self.device, self.prec, self.half_batch = device, prec, half_batch
        self.frozen = frozen  # a planted fault: the state comes back as it was
        self.p = {k: v.detach().clone().to(device, torch.float32)
                  for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0
        tc = self.train
        self.n = int(tc["num_envs"])
        self.state = E.init(seed, self.n, self.envp, device)
        pol = nets.make(self.run, self.p, prec)
        self.carry = pol.initial_carry(self.n, device)
        self.generator = torch.Generator().manual_seed(seed)
        # run.total_updates is the run's length: the anneal spans it
        self.total_steps = (int(self.run["total_updates"]) * int(tc["epochs"])
                            * int(tc["num_minibatches"]))
        self.first_mu = None

    def policy(self, params=None):
        return nets.make(self.run, self.p if params is None else params,
                         self.prec)

    @torch.no_grad()
    def rollout(self, T: int, bptt: int):
        """T steps of every lane: (planes dict of (T, N, ...), anchors
        list of carries entering each bptt segment, statistics)."""
        pol = self.policy()
        s, carry = self.state, self.carry
        ls = pol.log_std()
        keys = ("obs", "act", "logp", "val", "rew", "done")
        out = {k: [] for k in keys}
        anchors = []
        stats = torch.zeros(4, dtype=torch.float64, device=self.device)
        for t in range(T):
            if pol.recurrent and t % bptt == 0:
                anchors.append(carry)
            obs = E.observe(s)
            m, v, carry2 = pol.forward(obs, carry)
            a = m + torch.exp(ls) * E.gauss4(s)
            logp = E.gaussian_logp(a, m, ls)
            s, r, done, ret, ln = E.step(s, a, self.envp)
            carry = nets.mask(carry2, done) if pol.recurrent else carry2
            for k, x in zip(keys, (obs, a, logp, v, r, done)):
                out[k].append(x)
            stats += torch.stack([done.sum(), r.sum(), ret.sum(),
                                  ln.sum()]).double()
        self.state, self.carry = s, carry
        planes = {k: torch.stack(v) for k, v in out.items()}
        return planes, anchors, stats

    @torch.no_grad()
    def advantages(self, planes):
        """GAE, the advantages normalized over the batch (population
        variance): (adv, ret), each (T, N)."""
        tc = self.train
        pol = self.policy()
        last_value = pol.forward(E.observe(self.state), self.carry)[1]
        gamma, lam = float(tc["gamma"]), float(tc["gae_lambda"])
        rew, val = planes["rew"], planes["val"]
        nonterm = 1.0 - planes["done"].to(torch.float32)
        adv = torch.empty_like(rew)
        next_adv = torch.zeros_like(last_value)
        next_val = last_value
        for t in range(rew.shape[0] - 1, -1, -1):
            delta = rew[t] + gamma * next_val * nonterm[t] - val[t]
            next_adv = delta + gamma * lam * nonterm[t] * next_adv
            adv[t] = next_adv
            next_val = val[t]
        ret = adv + val
        mean = adv.mean()
        var = ((adv - mean) ** 2).mean()
        return (adv - mean) / torch.sqrt(var + 1e-8), ret

    def minibatch_loss(self, planes, adv, ret, anchors, lanes, bptt):
        """(loss, [pg_loss, v_loss, entropy, approx_kl, clipfrac]) of one
        minibatch of lanes, differentiable in self.p."""
        tc = self.train
        pol = self.policy()
        ls = pol.log_std()
        sel = {k: v[:, lanes] for k, v in planes.items()}
        adv, ret = adv[:, lanes], ret[:, lanes]
        if pol.recurrent:
            T, L = sel["obs"].shape[:2]
            S = T // bptt

            def fold(x):  # (T, L, ...) -> (bptt, S * L, ...)
                x = x.reshape(S, bptt, L, *x.shape[2:]).transpose(0, 1)
                return x.reshape(bptt, S * L, *x.shape[3:])

            carry = tuple(torch.cat([a[k][lanes] for a in anchors])
                          for k in range(2))
            obs_f, done_f = fold(sel["obs"]), fold(sel["done"])
            ms, vs = [], []
            for t in range(bptt):
                m, v, carry = pol.forward(obs_f[t], carry)
                carry = nets.mask(carry, done_f[t])
                ms.append(m)
                vs.append(v)
            m, v = torch.stack(ms), torch.stack(vs)
            sel = {k: fold(x) for k, x in sel.items()}
            adv, ret = fold(adv), fold(ret)
        else:
            m, v, _ = pol.forward(sel["obs"].reshape(-1, E.OBS_DIM))
        m, v = m.reshape(-1, E.ACT_DIM), v.reshape(-1)
        a, logp_old = sel["act"].reshape(-1, E.ACT_DIM), sel["logp"].reshape(-1)
        v_old, adv, ret = sel["val"].reshape(-1), adv.reshape(-1), ret.reshape(-1)
        logp = E.gaussian_logp(a, m, ls)
        ratio = torch.exp(logp - logp_old)
        eps = float(tc["clip_eps"])
        pg = torch.maximum(-adv * ratio,
                           -adv * torch.clamp(ratio, 1.0 - eps, 1.0 + eps))
        vclip = float(tc["vf_clip"])
        vl = torch.maximum((v - ret) ** 2,
                           (v_old + torch.clamp(v - v_old, -vclip, vclip)
                            - ret) ** 2)
        ent = torch.sum(ls + 0.5 + _HALF_LOG_2PI)
        pg_loss, v_loss = pg.mean(), 0.5 * vl.mean()
        loss = (pg_loss + float(tc["vf_coef"]) * v_loss
                - float(tc["ent_coef"]) * ent)
        kl = (logp_old - logp).mean()
        clipfrac = ((ratio - 1.0).abs() > eps).to(torch.float32).mean()
        return loss, torch.stack([pg_loss, v_loss, ent, kl, clipfrac]).detach()

    @torch.no_grad()
    def adam(self, grads: dict):
        """clip_by_global_norm, then Adam (eps 1e-5) at the annealed lr."""
        tc = self.train
        gn = torch.sqrt(sum(torch.sum(g.double() * g.double())
                            for g in grads.values())).float()
        clip = float(tc["max_grad_norm"])
        scale = torch.where(gn > clip, clip / gn, torch.ones_like(gn))
        lr = float(tc["lr"])
        if tc.get("anneal_lr", False):
            lr = lr * (1.0 - min(self.count / self.total_steps, 1.0))
        self.count += 1
        b1, b2 = 0.9, 0.999
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        for k, g in grads.items():
            g = g * scale
            self.mu[k].mul_(b1).add_((1.0 - b1) * g)
            self.nu[k].mul_(b2).add_((1.0 - b2) * (g * g))
            upd = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2) + 1e-5)
            self.p[k].sub_(lr * upd)
        if self.first_mu is None:  # the first gradient as the optimizer got it
            self.first_mu = {k: v.clone() for k, v in self.mu.items()}

    def update(self):
        """One PPO update. Returns its metrics (the program's keys)."""
        if self.frozen:
            keep = [{k: v.clone() for k, v in d.items()}
                    for d in (self.p, self.mu, self.nu)]
            state = (self.state, self.carry, self.count)
            out = self._update()
            self.p, self.mu, self.nu = keep
            self.state, self.carry, self.count = state
            return out
        return self._update()

    def _update(self):
        tc = self.train
        T, E_, M = int(tc["horizon"]), int(tc["epochs"]), int(tc["num_minibatches"])
        bptt = int(tc.get("bptt_horizon", 0)) or T
        rows = self.n // 128
        mb_rows = rows // M
        rbu = row_block(mb_rows)
        rbl, n_rb, mb_rb = rbu * 128, rows // rbu, mb_rows // rbu
        perms = [torch.randperm(n_rb, generator=self.generator)
                 for _ in range(E_)]
        planes, anchors, stats = self.rollout(T, bptt)
        adv, ret = self.advantages(planes)
        losses, auxes = [], []
        offs = torch.arange(rbl)
        for e in range(E_):
            for mb in range(M):
                blocks = perms[e][mb * mb_rb:(mb + 1) * mb_rb]
                lanes = (blocks[:, None] * rbl + offs).reshape(-1)
                if self.half_batch:  # a planted fault: half the batch
                    lanes = lanes[:lanes.numel() // 2]
                lanes = lanes.to(self.device)
                for v in self.p.values():
                    v.requires_grad_(True)
                loss, aux = self.minibatch_loss(planes, adv, ret, anchors,
                                                lanes, bptt)
                grads = torch.autograd.grad(loss, list(self.p.values()))
                for v in self.p.values():
                    v.requires_grad_(False)
                self.adam(dict(zip(self.p, grads)))
                losses.append(loss.detach())
                auxes.append(aux)
        aux = torch.stack(auxes).mean(0)
        n_done = float(stats[0])
        return {"loss": float(torch.stack(losses).mean()),
                "reward_mean": float(stats[1]) / (T * self.n),
                "episodes": n_done,
                "ep_return_mean": float(stats[2]) / max(n_done, 1.0),
                "ep_length_mean": float(stats[3]) / max(n_done, 1.0),
                **{k: float(x) for k, x in zip(
                    ("pg_loss", "v_loss", "entropy", "approx_kl", "clipfrac"),
                    aux)}}
