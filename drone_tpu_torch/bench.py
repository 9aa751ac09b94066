"""Benchmark: aggregate env-steps/s of the env megakernel (K1) on the batched
task of a config, with the secondary phases of the reference's bench.
Prints ONE JSON line.

Counterpart of the repository's root `bench.py` (the JAX reference, which
stays as it is): the same phases, shapes and JSON keys, and one more key,
"device", the card's name and power limit. Every phase is measured
REPEATS times after a warm-up call and reported as the median, with the
relative spread (max - min) / median of each phase in "spread". Each timed
region chains its phase's calls and ends with a value read
(`float(stats["reward_sum"])` or `float(metrics["loss"])`), which waits for
the card.

vs_baseline is the reference's: the measured steps/s over a 6.25 M
steps/s share (100 M over 16 chips) of the spec's target.

Deliberate deviations from the reference:
  - the policies' weights are the port's own seeded initialisation (seed 0,
    a torch.Generator), not flax's, so episode lengths, and with them the
    acting kernels' reset rates, differ from the reference's;
  - a phase that raises makes the bench raise: no phase is hidden behind
    None;
  - the scan_* training phases run the port's scan trainers
    (`ppo.make_train_step`, `ppo_rnn.make_recurrent_train_step`): autograd
    through the policy module with K4 as the optimizer, where the reference
    runs its XLA scan trainer with optax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from drone_tpu_torch import ppo, ppo_cnn_cuda, ppo_cuda, ppo_rnn, ppo_rnn_cuda
from drone_tpu_torch.env import DroneEnv
from drone_tpu_torch.models import (
    ActorCritic,
    CNNLSTMActorCritic,
    LSTMActorCritic,
    PatchCNNActorCritic,
    PixelActorCritic,
)
from drone_tpu_torch.ops import (
    act_rollout_cuda,
    cnn_act_rollout_cuda,
    lstm_act_rollout_cuda,
    rollout_cuda,
    traj_rollout_cuda,
)
from drone_tpu_torch.ppo import PPOConfig, init_runner
from drone_tpu_torch.ppo_rnn import init_recurrent_runner
from drone_tpu_torch.rollout import rollout_policy
from drone_tpu_torch.types import resolve_device

REPEATS = 3
SEED = 0


def measure(run_iters, sync, steps_per_repeat):
    """Time `run_iters()` (which queues the phase's chained calls) REPEATS
    times; `sync()` ends each region with a value read from the card.
    Returns the per-repeat steps/s list."""
    rates = []
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        run_iters()
        sync()
        rates.append(steps_per_repeat / (time.perf_counter() - t0))
    return rates


def med_spread(rates):
    """(median, relative spread). Spread = (max - min) / median: two runs of
    the same bench agree within the larger of their spreads."""
    r = sorted(rates)
    m = r[len(r) // 2]
    return m, (r[-1] - r[0]) / m if m else 0.0


def _generator():
    return torch.Generator().manual_seed(SEED)


def _chain(call, box, steps, sync_key, iters):
    """The phases' common loop: box holds the carried inputs and, last, the
    outputs' dict; call(box) runs one call and stores its outputs into box.
    One warm-up call, then `iters` chained calls a timed repeat, each
    region ended by float(box[-1][sync_key])."""
    call(box)
    float(box[-1][sync_key])

    def run():
        for _ in range(iters):
            call(box)

    return measure(run, lambda: float(box[-1][sync_key]), steps * iters)


def bench_megakernel(env, N=131072, T=4096, iters=4):
    """The env megakernel K1: T env steps a lane with in-kernel actions."""
    box = [env.init_batch(SEED, N), None]

    def call(b):
        b[0], b[1] = rollout_cuda(b[0], env.params, env.statics, T)

    return _chain(call, box, N * T, "reward_sum", iters)


@torch.no_grad()
def bench_acting_megakernel(env, N=131072, T=1024, iters=4):
    """Deterministic MLP policy fused into the env kernel (K5, serving)."""
    model = ActorCritic(generator=_generator()).to(env.device)
    box = [env.init_batch(SEED, N), None]

    def call(b):
        b[0], b[1] = act_rollout_cuda(b[0], model, env.params, env.statics, T)

    return _chain(call, box, N * T, "reward_sum", iters)


@torch.no_grad()
def bench_policy_rollout(env, N=131072, T=256, iters=4):
    """The MLP policy with Gaussian noise stepped through the batched env
    by torch ops, no kernel (the reference's counterpart is its lax.scan
    rollout)."""
    model = ActorCritic(generator=_generator()).to(env.device)
    generator = torch.Generator(device=env.device).manual_seed(SEED)

    def policy(obs, gen):
        mean, log_std, _ = model(obs)
        noise = torch.randn(mean.shape, generator=gen, device=mean.device)
        return mean + torch.exp(log_std) * noise, None

    box = [env.init_batch(SEED, N), None]

    def call(b):
        b[0], (out, _) = rollout_policy(b[0], policy, T, env.params,
                                        env.statics, generator=generator)
        b[1] = {"reward_sum": out.reward.sum()}

    return _chain(call, box, N * T, "reward_sum", iters)


@torch.no_grad()
def bench_traj_rollout(env, N=131072, T=512, iters=4):
    """The trajectory-emitting rollout kernel alone (K2, the MLP trainer's
    rollout phase), its PPO training planes written to device memory."""
    model = ActorCritic(generator=_generator()).to(env.device)
    theta = model.flatten_()
    box = [env.init_batch(SEED, N), None]

    def call(b):
        b[0], _, b[1] = traj_rollout_cuda(b[0], theta, model.hidden,
                                          env.params, env.statics, T)

    return _chain(call, box, N * T, "reward_sum", iters)


@torch.no_grad()
def _bench_lstm_acting(env, model, N, T, iters):
    model = model.to(env.device)
    theta, arch = model.flat_params(), (model.hidden, model.encoder)
    box = [env.init_batch(SEED, N), model.initial_carry(N, env.device), None]

    def call(b):
        b[0], b[1], b[2] = lstm_act_rollout_cuda(b[0], theta, arch, b[1],
                                                 env.params, env.statics, T)

    return _chain(call, box, N * T, "reward_sum", iters)


def bench_lstm_acting(env, N=131072, T=512, iters=2):
    """The LSTM policy fused into the env kernel (K8's dense arm)."""
    return _bench_lstm_acting(env, LSTMActorCritic(generator=_generator()),
                              N, T, iters)


def bench_cnn_lstm_acting(env, N=131072, T=256, iters=2):
    """The pixel-recurrent policy fused into the env kernel (K8's CNN arm:
    render, patch CNN, LSTM and env in one kernel)."""
    return _bench_lstm_acting(env, CNNLSTMActorCritic(generator=_generator()),
                              N, T, iters)


@torch.no_grad()
def bench_cnn_acting(env, N=131072, T=256, iters=2):
    """The patch-CNN policy fused into the env kernel (K11: render, convs
    and env step, statistics only)."""
    model = PatchCNNActorCritic(generator=_generator()).to(env.device)
    theta = model.flat_params()
    box = [env.init_batch(SEED, N), None]

    def call(b):
        b[0], b[1] = cnn_act_rollout_cuda(b[0], theta, model.arch,
                                          env.params, env.statics, T)

    return _chain(call, box, N * T, "reward_sum", iters)


def _bench_train(make_runner_and_step, N, T, iters):
    """The train phases' loop: one warm-up step, then `iters` chained
    steps a timed repeat."""
    runner, step = make_runner_and_step()
    box = [runner, None]

    def call(b):
        b[0], b[1] = step(b[0])

    return _chain(call, box, N * T, "loss", iters)


def _ppo_config(N, T, **extra):
    """The train phases' config: the reference's 4 epochs x 4 minibatches."""
    return PPOConfig(horizon=T, num_envs=N, epochs=4, num_minibatches=4,
                     **extra)


def bench_train(env, N=65536, T=128, iters=6):
    """The MLP megakernel PPO train step (K2 rollout, GAE, K3 update, K4
    clip+adam): train samples/s."""
    cfg = _ppo_config(N, T)

    def mk():
        model = ActorCritic(generator=_generator())
        return (init_runner(model, env, cfg, seed=SEED),
                ppo_cuda.make_train_step(env, cfg))

    return _bench_train(mk, N, T, iters)


def bench_train_rnn(env, N=65536, T=128, bptt=16, iters=4, policy="lstm"):
    """The recurrent megakernel PPO train step (K6 rollout, GAE, K7
    truncated-BPTT update, K4); policy="cnn_lstm" runs the CNN-encoder
    arms of K6 and K7 through the same trainer."""
    cfg = _ppo_config(N, T, bptt_horizon=bptt)
    family = CNNLSTMActorCritic if policy == "cnn_lstm" else LSTMActorCritic

    def mk():
        model = family(generator=_generator())
        return (init_recurrent_runner(model, env, cfg, seed=SEED),
                ppo_rnn_cuda.make_rnn_train_step(env, cfg))

    return _bench_train(mk, N, T, iters)


def bench_train_cnn(env, N=65536, T=128, iters=4):
    """The patch-CNN megakernel PPO train step (K9 rollout, GAE, K10
    update, K4)."""
    cfg = _ppo_config(N, T)

    def mk():
        model = PatchCNNActorCritic(generator=_generator())
        return (init_runner(model, env, cfg, seed=SEED),
                ppo_cnn_cuda.make_cnn_train_step(env, cfg))

    return _bench_train(mk, N, T, iters)


def _bench_scan(env, model_cls, N, T, iters, **extra):
    """A feed-forward scan-trainer phase: model_cls from the bench's seed,
    4 epochs x 4 minibatches."""
    cfg = _ppo_config(N, T, **extra)

    def mk():
        model = model_cls(generator=_generator())
        return (ppo.init_runner(model, env, cfg, seed=SEED),
                ppo.make_train_step(model, env, cfg))

    return _bench_train(mk, N, T, iters)


def bench_train_scan(env, N=65536, T=128, iters=4):
    """The MLP scan PPO train step (the policy module's rollout, GAE,
    autograd update, K4) at bench_train's shape: the denominator of the
    megakernel-over-scan ratio."""
    return _bench_scan(env, ActorCritic, N, T, iters)


def bench_train_rnn_scan(env, N=65536, T=128, bptt=16, iters=2):
    """The recurrent scan PPO train step (segmented_forward truncated BPTT
    by autograd, K4) at bench_train_rnn's shape."""
    cfg = _ppo_config(N, T, bptt_horizon=bptt)

    def mk():
        model = LSTMActorCritic(generator=_generator())
        return (ppo_rnn.init_recurrent_runner(model, env, cfg, seed=SEED),
                ppo_rnn.make_recurrent_train_step(model, env, cfg))

    return _bench_train(mk, N, T, iters)


def bench_train_cnn_scan(env, N=4096, T=128, iters=4):
    """The scan PPO train step with the patch-CNN policy at the reference's
    4,096 envs: the CNN megakernel's denominator (cnn_train_sps_4k)."""
    return _bench_scan(env, PatchCNNActorCritic, N, T, iters)


def bench_train_cnn_overlap_scan(env, N=65536, T=128, iters=2,
                                 grad_accum=16):
    """The scan PPO train step with the overlapping-conv PixelActorCritic
    at 65,536 envs, each minibatch's forward and backward in grad_accum
    chunks (run.policy=cnn_overlap has no megakernel)."""
    return _bench_scan(env, PixelActorCritic, N, T, iters,
                       grad_accum=grad_accum)


def phases(env) -> list:
    """[(key, phase returning its per-repeat rates)] in the reference's
    order; hover/euler runs every phase."""
    out = [
        ("acting_megakernel_sps",
         lambda: bench_acting_megakernel(env)),
        ("scan_policy_rollout_sps",
         lambda: bench_policy_rollout(env)),
    ]
    if (env.statics.task, env.statics.integrator) != ("hover", "euler"):
        return out
    out += [
        ("traj_rollout_sps", lambda: bench_traj_rollout(env)),
        ("lstm_acting_sps", lambda: bench_lstm_acting(env)),
        ("cnn_acting_sps", lambda: bench_cnn_acting(env)),
        ("cnn_lstm_acting_sps",
         lambda: bench_cnn_lstm_acting(env)),
        ("train_sps_64k", lambda: bench_train(env, N=65536)),
        ("scan_train_sps_64k",
         lambda: bench_train_scan(env, N=65536)),
        ("train_sps_262k",
         lambda: bench_train(env, N=262144)),
        ("lstm_train_sps_64k",
         lambda: bench_train_rnn(env, N=65536)),
        ("scan_lstm_train_sps_64k",
         lambda: bench_train_rnn_scan(env, N=65536)),
        ("cnn_lstm_train_sps_64k",
         lambda: bench_train_rnn(env, N=65536, iters=3, policy="cnn_lstm")),
        ("cnn_train_sps_64k",
         lambda: bench_train_cnn(env, N=65536)),
        ("cnn_train_sps_4k",
         lambda: bench_train_cnn(env, N=4096)),
        ("scan_cnn_train_sps_4k",
         lambda: bench_train_cnn_scan(env, N=4096)),
        ("scan_cnn_overlap_train_sps_64k",
         lambda: bench_train_cnn_overlap_scan(env, N=65536)),
    ]
    return out


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i",
                          str(device.index or 0)],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def result(task, device, mega, mega_spread, rates) -> dict:
    """The JSON object: the reference's keys and "device". rates: {key:
    per-repeat rates}."""
    secondary, spread = {}, {"headline": round(mega_spread, 4)}
    for key, r in rates.items():
        m, s = med_spread(r)
        secondary[key] = round(m, 1)
        spread[key] = round(s, 4)
    return {
        "metric": f"env_steps_per_s_batched_{task}_1chip",
        "value": round(mega, 1),
        "unit": "steps/s",
        "vs_baseline": round(mega / (100e6 / 16.0), 3),
        "secondary": secondary,
        "spread": spread,
        "repeats": REPEATS,
        "device": device,
    }


def main(cfg=None, device="cuda") -> dict:
    """cfg: an optional Config (from the CLI); its [env] section picks the
    task and integrator. Runs on the card unless device='cpu' (the plain
    versions, at the reference's full shapes: slow). Prints the JSON line
    and returns it as a dict."""
    device = resolve_device(device)
    if cfg is not None:
        statics, params = cfg.env.build()
        env = DroneEnv(task=statics.task, integrator=statics.integrator,
                       params=params, device=device)
    else:
        env = DroneEnv(device=device)
    mega, mega_spread = med_spread(bench_megakernel(env))
    rates = {}
    for key, fn in phases(env):
        rates[key] = fn()
        print(f"secondary bench {key}: {med_spread(rates[key])[0] / 1e6:.2f}M"
              f" steps/s", file=sys.stderr, flush=True)
    out = result(env.statics.task, device_name(device), mega, mega_spread,
                 rates)
    print(json.dumps(out), flush=True)
    return out

