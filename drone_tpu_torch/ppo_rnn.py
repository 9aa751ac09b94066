"""Recurrent PPO: the scan trainer and its hybrid tier (counterpart of
`drone_tpu/ppo_rnn.py`).

The runner state of the recurrent trainers (the feed-forward runner plus
the LSTM carry), its initialisation, the per-lane carry reset on episode
end, the module rollout that evaluation takes for a stochastic or ragged
run, `segmented_forward` (truncated BPTT over stored data, the segments
folded into the batch) and `make_recurrent_train_step`, in two tiers:

  - rollout="scan": the policy module and the env step in a loop,
    recording the carry entering each bptt segment (the anchors), noise
    from the runner's noise generator;
  - rollout="pallas" (the hybrid tier): K6 (`ops.traj_lstm_rollout_cuda`)
    streams the planes and the anchors, its noise from the lanes' counter
    streams, its episode statistics the kernel's own.

Both then run epochs x minibatches of autograd through
`segmented_forward` on the PPO loss and K4 on the flat gradient, as the
feed-forward scan trainer (`ppo.make_train_step`) does; minibatches split
the lanes, whole sequences each. The recurrent megakernel trainer is
`ppo_rnn_cuda.make_rnn_train_step`. The reference recomputes each step's
activations in the backward pass (`jax.checkpoint`) to fit 16 GB; here
autograd keeps them, which the bench's shapes leave room for on 80 GB.
"""

from __future__ import annotations

import dataclasses

import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.ppo import (
    AUX_KEYS,
    Optimizer,
    PPOConfig,
    RunnerState,
    Transition,
    draw_noise,
    gae_normalized,
    init_fused_opt_state,
    noise_generator,
    ppo_loss,
    sample_action,
    scan_flags,
    scan_metrics,
    scan_permutations,
)
from drone_tpu_torch.rollout import _stack_outs
from drone_tpu_torch.types import ACT_DIM, OBS_DIM


@dataclasses.dataclass
class RecurrentRunnerState(RunnerState):
    """RunnerState plus the LSTM carry (c, h), each (N, hidden), entering
    the next update's first step."""

    carry: tuple = ()


def mask_carry(carry, done):
    """Zero the recurrent state of lanes whose episode just ended
    (ppo_rnn._mask_carry)."""
    keep = (1.0 - done.to(torch.float32))[:, None]
    return tuple(t * keep for t in carry)


def init_recurrent_runner(model, env, cfg: PPOConfig, seed: int = 0,
                          first_lane: int = 0) -> RecurrentRunnerState:
    """Fresh RecurrentRunnerState: the LSTMActorCritic (or
    CNNLSTMActorCritic) moved to the env's device and flattened, a zero
    fused optimizer state, cfg.num_envs lanes of episode 0 under `seed`
    from lane first_lane on, a zero carry, and the permutation and noise
    generators seeded with `seed`."""
    model = model.to(env.device)
    flat = model.flatten_()
    env_state = env.init_batch(seed, cfg.num_envs, first_lane=first_lane)
    return RecurrentRunnerState(
        params=model,
        opt_state=init_fused_opt_state(flat),
        env_state=env_state,
        last_obs=env_mod.observe(env_state),
        generator=torch.Generator().manual_seed(seed),
        update_idx=0,
        carry=model.initial_carry(cfg.num_envs, env.device),
        noise_generator=noise_generator(seed, env.device),
    )


@torch.no_grad()
def rollout_recurrent(model, env, state, carry, steps: int,
                      generator: torch.Generator | None = None,
                      deterministic: bool = True):
    """Policy rollout for evaluation through the module (either recurrent
    family): returns (final_state, final_carry, StepOut stacked over T). A
    stochastic rollout draws its noise from `generator` (on the env's
    device)."""
    if generator is None and not deterministic:
        raise ValueError("a stochastic rollout_recurrent needs a generator")
    obs = env_mod.observe(state)
    outs = []
    for _ in range(steps):
        mean, log_std, _, carry = model(obs, carry)
        action = mean
        if not deterministic:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device)
            action = mean + torch.exp(log_std) * noise
        state, out = env_mod.step(state, action, env.params, env.statics)
        carry = mask_carry(carry, out.terminated | out.truncated)
        obs = out.obs
        outs.append(out)
    return state, carry, _stack_outs(outs)


def segmented_forward(model, obs, done, carry0, bptt: int):
    """Truncated-BPTT re-run of the recurrent policy over stored data.

    obs (T, L, 13); done (T, L); carry0: (c, h), each (S, L, hidden), the
    carries entering each segment (S = T // bptt). Returns (mean, log_std,
    value), each (T, L, ...). The segments are folded into the batch (one
    loop of bptt steps over S * L sequences), so the gradients flow through
    time within a segment and stop at its start (the stored carry is data).
    With bptt == T it is the full-horizon pass."""
    T, L = obs.shape[0], obs.shape[1]
    S = T // bptt

    def fold(x):
        x = x.reshape(S, bptt, *x.shape[1:]).transpose(0, 1)
        return x.reshape(bptt, S * L, *x.shape[3:])

    def unfold(x):
        x = x.reshape(bptt, S, L, *x.shape[2:]).transpose(0, 1)
        return x.reshape(T, L, *x.shape[3:])

    carry = tuple(c.reshape(S * L, *c.shape[2:]) for c in carry0)
    obs_f, done_f = fold(obs), fold(done)
    outs = []
    for t in range(bptt):
        mean, log_std, value, carry = model(obs_f[t], carry)
        carry = mask_carry(carry, done_f[t])
        outs.append((mean, log_std, value))
    return tuple(unfold(torch.stack(xs)) for xs in zip(*outs))


def bptt_of(cfg: PPOConfig) -> int:
    """The truncated-BPTT segment length: train.bptt_horizon, or the whole
    horizon when it is 0."""
    bptt = cfg.bptt_horizon or cfg.horizon
    if cfg.horizon % bptt:
        raise ValueError(f"horizon ({cfg.horizon}) must be a multiple of "
                         f"bptt_horizon ({bptt})")
    return bptt


@torch.no_grad()
def collect_recurrent(model, env, runner, T: int, bptt: int, noise=None):
    """T policy + env steps through the module: (final EnvState, last obs,
    last carry, Transition, anchors (c, h) each (S, N, hidden)). noise as
    in ppo.collect."""
    state, obs, carry = runner.env_state, runner.last_obs, runner.carry
    n, dev = state.n, obs.device
    S = T // bptt
    anchors = tuple(torch.empty(S, n, c.shape[1], device=dev) for c in carry)
    traj = Transition(
        obs=torch.empty(T, n, OBS_DIM, device=dev),
        action=torch.empty(T, n, ACT_DIM, device=dev),
        logp=torch.empty(T, n, device=dev),
        value=torch.empty(T, n, device=dev),
        reward=torch.empty(T, n, device=dev),
        done=torch.empty(T, n, dtype=torch.bool, device=dev),
        ep_return=torch.empty(T, n, device=dev),
        ep_length=torch.empty(T, n, dtype=torch.int32, device=dev))
    for t in range(T):
        if t % bptt == 0:
            for a, c in zip(anchors, carry):
                a[t // bptt] = c
        mean, log_std, value, carry2 = model(obs, carry)
        z = noise[t] if noise is not None else draw_noise(runner, mean.shape,
                                                          dev)
        action, logp = sample_action(mean, log_std, z)
        state, out = env_mod.step(state, action, env.params, env.statics)
        done = out.terminated | out.truncated
        carry = mask_carry(carry2, done)
        for name, v in (("obs", obs), ("action", action), ("logp", logp),
                        ("value", value), ("reward", out.reward),
                        ("done", done), ("ep_return", out.ep_return),
                        ("ep_length", out.ep_length)):
            getattr(traj, name)[t] = v
        obs = out.obs
    return state, obs, carry, traj, anchors


def planes_to_traj(planes) -> Transition:
    """K6's (T, N_TRAJ, N) planes -> a Transition with (T, N, ...) views
    (the reference's _planes_to_traj); ep_return and ep_length are not in
    the planes (the kernel's statistics carry the episodes)."""
    from drone_tpu_torch.ops.cuda_acting_traj import (
        TP_ACT0,
        TP_DONE,
        TP_LOGP,
        TP_OBS0,
        TP_REW,
        TP_VAL,
    )

    def vec(p0, d):
        return planes[:, p0:p0 + d].transpose(1, 2)

    return Transition(obs=vec(TP_OBS0, OBS_DIM), action=vec(TP_ACT0, ACT_DIM),
                      logp=planes[:, TP_LOGP], value=planes[:, TP_VAL],
                      reward=planes[:, TP_REW],
                      done=planes[:, TP_DONE] != 0.0, ep_return=None,
                      ep_length=None)


def make_recurrent_train_step(model, env, cfg: PPOConfig,
                              rollout: str = "scan", permutations=None,
                              noise=None, on_phase=None, mesh=None):
    """Build the recurrent scan train step (rollout="scan") or its hybrid
    tier (rollout="pallas", K6's rollout): RecurrentRunnerState ->
    (RecurrentRunnerState, metrics). permutations: optional callable
    runner -> (epochs, num_envs) lane permutations; noise: optional
    callable runner -> (T, N, 4) standard-normal noise (the scan rollout
    only); on_phase and mesh as in ppo.make_train_step."""
    del model
    if rollout not in ("scan", "pallas"):
        raise ValueError(f"rollout must be 'scan' or 'pallas', got "
                         f"{rollout!r}")
    if cfg.num_envs % cfg.num_minibatches:
        raise ValueError(f"num_envs ({cfg.num_envs}) must divide into "
                         f"{cfg.num_minibatches} minibatches (recurrent PPO "
                         f"minibatches whole lanes)")
    bptt = bptt_of(cfg)
    mb_lanes = cfg.num_envs // cfg.num_minibatches
    opt = Optimizer(cfg, mesh)
    n_steps = cfg.epochs * cfg.num_minibatches
    mark = on_phase or (lambda name: None)

    def collect_kernel(runner):
        from drone_tpu_torch.ops.cuda_acting_lstm import (
            traj_lstm_rollout_cuda,
        )

        module = runner.params
        final, last_carry, planes, snap, stats = traj_lstm_rollout_cuda(
            runner.env_state, module.flat, (module.hidden, module.encoder),
            runner.carry, env.params, env.statics, cfg.horizon, bptt)
        anchors = (snap[:, 0].transpose(1, 2), snap[:, 1].transpose(1, 2))
        return (final, env_mod.observe(final), last_carry,
                planes_to_traj(planes), anchors, stats)

    def train_step(runner: RecurrentRunnerState):
        torch.backends.cuda.matmul.allow_tf32 = False
        mark("rollout")
        module = runner.params
        if getattr(module, "flat", None) is None:
            raise ValueError("the model's parameters are not flat: call "
                             "flatten_() (init_recurrent_runner does)")
        if runner.env_state.n != cfg.num_envs:
            raise ValueError(f"the runner has {runner.env_state.n} lanes, "
                             f"the config {cfg.num_envs}")
        dev = module.flat.device
        perms = scan_permutations(runner, permutations, cfg, cfg.num_envs,
                                  dev)
        with scan_flags():
            if rollout == "scan":
                z = noise(runner) if noise is not None else None
                final, last_obs, last_carry, traj, anchors = \
                    collect_recurrent(module, env, runner, cfg.horizon, bptt,
                                      z)
                stats = None
            else:
                (final, last_obs, last_carry, traj, anchors,
                 stats) = collect_kernel(runner)
            mark("gae")
            with torch.no_grad():
                last_value = module(last_obs, last_carry)[2]
            adv, ret = gae_normalized(traj, last_value, cfg, mesh)
            full = dict(obs=traj.obs, action=traj.action, logp=traj.logp,
                        value=traj.value, done=traj.done, adv=adv, ret=ret)

            def loss_fn(mb):
                mean, log_std, value = segmented_forward(
                    module, mb["obs"], mb["done"], mb["carry0"], bptt)
                return ppo_loss(cfg, mean, log_std, value, mb)

            mark("update")
            per_step = torch.empty(n_steps, 1 + len(AUX_KEYS), device=dev)
            i = 0
            for e in range(cfg.epochs):
                for m in range(cfg.num_minibatches):
                    take = perms[e, m * mb_lanes:(m + 1) * mb_lanes]
                    mb = {k: v[:, take] for k, v in full.items()}
                    mb["carry0"] = tuple(a[:, take] for a in anchors)
                    per_step[i] = opt.step(runner, loss_fn, [mb])
                    i += 1
        mark("metrics")
        metrics = scan_metrics(traj, stats, per_step, dev, mesh)
        runner2 = dataclasses.replace(runner, env_state=final,
                                      last_obs=last_obs, carry=last_carry,
                                      update_idx=runner.update_idx + 1)
        mark("end")
        return runner2, metrics

    return train_step
