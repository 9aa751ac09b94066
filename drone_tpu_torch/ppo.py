"""PPO and the scan trainer (counterpart of `drone_tpu/ppo.py`).

PPOConfig, the Gaussian policy's log-prob and entropy, GAE, the runner
state a train step carries, and the scan trainer, `make_train_step`: the
rollout through the policy module and the env step, GAE, and epochs x
minibatches of autograd on the module's PPO loss, each followed by K4
(`ops.cuda_update.fused_adam_cuda`), the optimizer the megakernel trainers
use. It trains every feed-forward policy family (ActorCritic,
PatchCNNActorCritic, PixelActorCritic); `ppo_rnn` builds the recurrent
one on the same pieces. The megakernel trainers are `ppo_cuda`,
`ppo_cnn_cuda` and `ppo_rnn_cuda`.

One optimizer state for every trainer: the parameters are views of one
flat buffer (`flatten_`), the gradient of each SGD step is written into a
flat buffer in the same order, and K4 updates the buffer and the flat
moments (count, mu, nu) in place. A checkpoint of either trainer resumes
under the other as it is (the reference converts optax's state to its
fused one and back, `drone_tpu/train.py` `_restore_any_trainer`).

Deliberate changes from the reference's scan trainer: the exploration
noise comes from the runner's `noise_generator` (a torch.Generator on the
env's device, seeded with the run's seed; the reference splits its host
PRNG key), and the permutations from its CPU `generator`. The products
run in float32 (no TF32: `torch.backends.cuda.matmul.allow_tf32` off, and
cuDNN's convolutions under `scan_flags`, deterministic algorithms and no
TF32), so an update on the card is bitwise repeatable and a resumed run
repeats an uninterrupted one.

Conventions (the reference's CleanRL lineage): done = terminated |
truncated ends bootstrapping; advantages are normalized over the batch; a
Gaussian policy with a state-independent log_std and a raw (unsquashed)
log-prob.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.dynamics import sqrt_rn
from drone_tpu_torch.models.mlp import tensor_sizes
from drone_tpu_torch.parallel.mesh import all_mean, all_sum
from drone_tpu_torch.types import EnvState
from drone_tpu_torch.utils.profiling import phases

METRIC_KEYS = ("loss", "reward_mean", "episodes", "ep_return_mean",
               "ep_length_mean", "pg_loss", "v_loss", "entropy", "approx_kl",
               "clipfrac")
AUX_KEYS = METRIC_KEYS[5:]


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Static training hyperparameters, with the reference's defaults."""

    horizon: int = 128          # rollout length T per update
    num_envs: int = 4096        # lanes B
    epochs: int = 4
    num_minibatches: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_clip: float = 10.0
    vf_coef: float = 0.5
    ent_coef: float = 0.001
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    anneal_lr: bool = False
    total_updates: int = 200    # used by lr annealing
    shuffle: str = "lanes"      # "lanes" | "flat" minibatch shuffling
    bptt_horizon: int = 0       # recurrent PPO: truncated-BPTT segment length
    grad_accum: int = 1         # scan trainer: gradient-accumulation chunks


_LOG_2PI = math.log(2.0 * math.pi)


def gaussian_logp(action, mean, log_std):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return torch.sum(-0.5 * z * z - log_std - 0.5 * _LOG_2PI, dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * (1.0 + _LOG_2PI), dim=-1)


def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """Generalized advantage estimation by a reverse loop over time.

    rewards/values/dones: (T, ...); last_value: (...). Returns (advantages,
    returns), each shaped like rewards."""
    nonterminal = 1.0 - dones.to(torch.float32)
    adv = torch.empty_like(rewards)
    next_adv = torch.zeros_like(last_value)
    next_value = last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_value * nonterminal[t] - values[t]
        next_adv = delta + gamma * lam * nonterminal[t] * next_adv
        adv[t] = next_adv
        next_value = values[t]
    return adv, adv + values


def normalize_advantages(adv, mesh=None):
    """(adv - mean) / sqrt(var + 1e-8) over the whole batch, the variance
    the population one, the mean of the squared deviations (jnp.var's
    formula). With a mesh (parallel.mesh.Mesh) over every rank's batch:
    the global mean, then the global mean of the squared deviations from
    it, as the reference's pmeans (ppo.py:275-277); on a world of one that
    is the same arithmetic bit for bit."""
    mean = all_mean(mesh, torch.mean(adv))
    var = all_mean(mesh, torch.mean((adv - mean) ** 2))
    return (adv - mean) / sqrt_rn(var + 1e-8)


@dataclasses.dataclass
class RunnerState:
    """What a train step carries from one update to the next.

    params: the policy module, its parameters views of one flat buffer
    (`params.flat`, `flatten_`); opt_state: (count 0-d float32, mu, nu),
    flat buffers in the same order; generator: the CPU generator of the
    minibatch permutations; noise_generator: the generator of the scan
    trainers' exploration noise, on the env's device (the megakernel
    trainers draw theirs from the lanes' counter streams)."""

    params: torch.nn.Module
    opt_state: tuple
    env_state: EnvState
    last_obs: torch.Tensor
    generator: torch.Generator
    update_idx: int = 0
    noise_generator: torch.Generator | None = None


def init_fused_opt_state(flat: torch.Tensor):
    """Fresh (count, mu, nu) of the fused optimizer for a flat parameter
    buffer: a zero step count and zero moments."""
    return (torch.zeros((), dtype=torch.float32, device=flat.device),
            torch.zeros_like(flat), torch.zeros_like(flat))


def noise_generator(seed: int, device) -> torch.Generator:
    """The scan trainers' exploration-noise generator on `device`."""
    return torch.Generator(device=device).manual_seed(seed)


def init_runner(model, env, cfg: PPOConfig, seed: int = 0,
                first_lane: int = 0) -> RunnerState:
    """Fresh RunnerState: the model moved to the env's device and
    flattened, a zero optimizer state, cfg.num_envs lanes of episode 0
    under `seed` from lane first_lane on, and the permutation and noise
    generators seeded with `seed`."""
    model = model.to(env.device)
    flat = model.flatten_()
    env_state = env.init_batch(seed, cfg.num_envs, first_lane=first_lane)
    return RunnerState(
        params=model,
        opt_state=init_fused_opt_state(flat),
        env_state=env_state,
        last_obs=env_mod.observe(env_state),
        generator=torch.Generator().manual_seed(seed),
        update_idx=0,
        noise_generator=noise_generator(seed, env.device),
    )


# ---------------------------------------------------------------------------
# the scan trainer
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Transition:
    """One rollout, time-major: obs (T, N, 13), action (T, N, 4), logp,
    value, reward (T, N), done (T, N) bool, ep_return and ep_length (T, N),
    nonzero where an episode ended."""

    obs: torch.Tensor
    action: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    ep_return: torch.Tensor
    ep_length: torch.Tensor


def make_optimizer(cfg: PPOConfig):
    """The reference's make_optimizer (clip_by_global_norm(max_grad_norm),
    then adam(lr, eps=1e-5) with an optional linear anneal over every
    optimizer step of the run) as K4's constants: (AdamConsts,
    LrSchedule)."""
    # imported here: drone_tpu_torch.ops imports ppo_rnn, which imports
    # this module
    from drone_tpu_torch.ops.cuda_update import AdamConsts, LrSchedule

    return (AdamConsts(clip_norm=cfg.max_grad_norm),
            LrSchedule(lr=cfg.lr, total_steps=cfg.total_updates * cfg.epochs
                       * cfg.num_minibatches, anneal=cfg.anneal_lr))


def scan_flags():
    """The scan trainers' cuDNN settings: deterministic algorithms, no
    TF32, no autotuning (float32 convolutions, bitwise repeatable)."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def ordered_params(model) -> list:
    """The module's parameters in its flat buffer's order."""
    named = dict(model.named_parameters())
    return [named[name] for name, _ in model.kernel_order()]


def sample_action(mean, log_std, z):
    """(action, logp) of the Gaussian policy at standard-normal noise z."""
    action = mean + torch.exp(log_std) * z
    return action, gaussian_logp(action, mean, log_std)


def draw_noise(runner, shape, device):
    """Standard-normal noise from the runner's noise generator."""
    return torch.randn(shape, generator=runner.noise_generator, device=device)


def scan_permutations(runner, permutations, cfg: PPOConfig, n: int, device):
    """One update's (epochs, n) permutations on `device`:
    permutations(runner) when given, else drawn from the runner's CPU
    generator (torch.randperm, one an epoch)."""
    perms = (permutations(runner) if permutations is not None
             else torch.stack([torch.randperm(n, generator=runner.generator)
                               for _ in range(cfg.epochs)]))
    perms = torch.as_tensor(perms, dtype=torch.int64)
    if perms.shape != (cfg.epochs, n):
        raise ValueError(f"the permutations must be ({cfg.epochs}, {n}), got "
                         f"{tuple(perms.shape)}")
    if device.type == "cuda":
        perms = perms.pin_memory()
    return perms.to(device, non_blocking=True)


def gae_normalized(traj: Transition, last_value, cfg: PPOConfig, mesh=None):
    """(normalized advantages, returns), each (T, N); normalized over every
    rank's batch with a mesh."""
    adv, ret = compute_gae(traj.reward, traj.value, traj.done, last_value,
                           cfg.gamma, cfg.gae_lambda)
    return normalize_advantages(adv, mesh), ret


def ppo_loss(cfg: PPOConfig, mean, log_std, value, mb: dict):
    """The reference's loss_fn on the policy's outputs at a minibatch's
    samples (mb: action, logp, value, adv, ret): (total, [pg_loss, v_loss,
    entropy, approx_kl, clipfrac])."""
    logp = gaussian_logp(mb["action"], mean, log_std)
    ratio = torch.exp(logp - mb["logp"])
    pg1 = -mb["adv"] * ratio
    pg2 = -mb["adv"] * torch.clamp(ratio, 1.0 - cfg.clip_eps,
                                   1.0 + cfg.clip_eps)
    pg_loss = torch.mean(torch.maximum(pg1, pg2))
    v_clipped = mb["value"] + torch.clamp(value - mb["value"], -cfg.vf_clip,
                                          cfg.vf_clip)
    v_loss = 0.5 * torch.mean(torch.maximum((value - mb["ret"]) ** 2,
                                            (v_clipped - mb["ret"]) ** 2))
    ent = torch.mean(gaussian_entropy(log_std))
    total = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
    approx_kl = torch.mean(mb["logp"] - logp)
    clipfrac = torch.mean((torch.abs(ratio - 1.0) > cfg.clip_eps)
                          .to(torch.float32))
    return total, [pg_loss, v_loss, ent, approx_kl, clipfrac]


class Optimizer:
    """One SGD step of the scan trainers: autograd's gradient of the mean
    loss over the module's parameters, written into one flat buffer in the
    flat order, then K4 on it (clip_by_global_norm + adam, in place on the
    runner's buffers). With a mesh the gradient is averaged over the ranks
    before K4, so K4 clips the averaged gradient."""

    def __init__(self, cfg: PPOConfig, mesh=None):
        self.ac, self.sched = make_optimizer(cfg)
        self.mesh = mesh

    def step(self, runner, loss_fn, chunks) -> torch.Tensor:
        """loss_fn(chunk) -> (loss, [aux]); the gradients of the chunks are
        summed in order and scaled by 1 / len(chunks) (the reference's
        grad_accum), as are the losses. Returns [loss, *aux] stacked."""
        from drone_tpu_torch.ops.cuda_update import fused_adam_cuda

        model = runner.params
        theta = model.flat
        params = ordered_params(model)
        grads = torch.empty_like(theta)
        total = None
        for k, chunk in enumerate(chunks):
            with torch.enable_grad():
                loss, aux = loss_fn(chunk)
                gs = torch.autograd.grad(loss, params)
            vals = torch.stack([loss.detach(), *(a.detach() for a in aux)])
            if k == 0:
                torch.cat([g.reshape(-1) for g in gs], out=grads)
                total = vals
            else:
                grads += torch.cat([g.reshape(-1) for g in gs])
                total = total + vals
        if len(chunks) > 1:
            inv = 1.0 / len(chunks)
            grads *= inv
            total = total * inv
        all_mean(self.mesh, grads)
        count, mu, nu = runner.opt_state
        fused_adam_cuda(theta, grads, mu, nu, count, self.ac, self.sched,
                        tensor_sizes(model.kernel_order()))
        return total


def scan_metrics(traj: Transition, stats, per_step, device, mesh=None):
    """The metrics of one update on the device, under METRIC_KEYS. stats:
    None to count the episodes from the trajectory, else the rollout
    kernel's sums (episodes, ep_return_sum, ep_length_sum); per_step:
    (steps, 6) [loss, *AUX_KEYS] of each SGD step. With a mesh the episode
    sums are summed over the ranks and the means averaged (ppo.py's psum
    and pmean)."""
    if stats is None:
        n_done = torch.sum(traj.done).to(torch.float32)
        ep_ret_sum = torch.sum(traj.ep_return)
        ep_len_sum = torch.sum(traj.ep_length).to(torch.float32)
    else:
        n_done, ep_ret_sum, ep_len_sum = (
            stats["episodes"], stats["ep_return_sum"], stats["ep_length_sum"])
    one = torch.ones((), device=device)
    means = torch.cat([torch.mean(per_step, dim=0),
                       torch.mean(traj.reward)[None]])
    if mesh is not None:
        n_done, ep_ret_sum, ep_len_sum = all_sum(
            mesh, torch.stack([n_done, ep_ret_sum, ep_len_sum]))
        all_mean(mesh, means)
    return dict(
        loss=means[0],
        reward_mean=means[-1],
        episodes=n_done,
        ep_return_mean=ep_ret_sum / torch.maximum(n_done, one),
        ep_length_mean=ep_len_sum / torch.maximum(n_done, one),
        **{k: means[1 + i] for i, k in enumerate(AUX_KEYS)},
    )


@torch.no_grad()
def collect(model, env, runner, T: int, noise=None):
    """T policy + env steps from the runner's state: (final EnvState, last
    obs, Transition). noise: (T, N, 4) standard-normal draws, or None to
    draw them from the runner's noise generator."""
    state, obs = runner.env_state, runner.last_obs
    n, dev = state.n, obs.device
    traj = Transition(
        obs=torch.empty(T, n, obs.shape[1], device=dev),
        action=torch.empty(T, n, 4, device=dev),
        logp=torch.empty(T, n, device=dev),
        value=torch.empty(T, n, device=dev),
        reward=torch.empty(T, n, device=dev),
        done=torch.empty(T, n, dtype=torch.bool, device=dev),
        ep_return=torch.empty(T, n, device=dev),
        ep_length=torch.empty(T, n, dtype=torch.int32, device=dev))
    for t in range(T):
        mean, log_std, value = model(obs)
        z = noise[t] if noise is not None else draw_noise(runner, mean.shape,
                                                          dev)
        action, logp = sample_action(mean, log_std, z)
        state, out = env_mod.step(state, action, env.params, env.statics)
        for name, v in (("obs", obs), ("action", action), ("logp", logp),
                        ("value", value), ("reward", out.reward),
                        ("done", out.terminated | out.truncated),
                        ("ep_return", out.ep_return),
                        ("ep_length", out.ep_length)):
            getattr(traj, name)[t] = v
        obs = out.obs
    return state, obs, traj


def _check_geometry(cfg: PPOConfig):
    """(minibatch samples, lanes a minibatch or None) of the scan trainer,
    or a ValueError naming what does not split."""
    if cfg.shuffle not in ("lanes", "flat"):
        raise ValueError(f"shuffle must be 'lanes' or 'flat', got "
                         f"{cfg.shuffle!r}")
    batch = cfg.horizon * cfg.num_envs
    if cfg.shuffle == "lanes" and cfg.num_envs % cfg.num_minibatches:
        raise ValueError(f"num_envs ({cfg.num_envs}) must divide into "
                         f"{cfg.num_minibatches} minibatches "
                         f"(shuffle='lanes')")
    if batch % cfg.num_minibatches:
        raise ValueError(f"horizon*envs ({batch}) must divide into "
                         f"{cfg.num_minibatches} minibatches")
    mb_size = batch // cfg.num_minibatches
    if cfg.grad_accum < 1 or mb_size % cfg.grad_accum:
        raise ValueError(f"minibatch size ({mb_size}) must divide into "
                         f"grad_accum ({cfg.grad_accum}) equal sample chunks")
    lanes = (cfg.num_envs // cfg.num_minibatches if cfg.shuffle == "lanes"
             else None)
    return mb_size, lanes


def make_train_step(model, env, cfg: PPOConfig, permutations=None,
                    noise=None, on_phase=None, mesh=None):
    """Build the scan train step for `model`'s family (a feed-forward
    policy: obs -> (mean, log_std, value)): RunnerState -> (RunnerState,
    metrics), with the env's params and device. The runner's module is
    the one trained; `model` fixes the family only.

    permutations: optional callable runner -> (epochs, n) permutations (n
    the lanes with shuffle="lanes", horizon x lanes with "flat"); noise:
    optional callable runner -> (T, N, 4) standard-normal noise. Both exist
    to replay another trainer's draws (the tests feed in the reference's);
    by default they come from the runner's generators. on_phase as in
    ppo_cuda.make_train_step ("rollout", "gae", "update", "metrics",
    "end"). mesh: None, or the parallel.mesh.Mesh whose ranks each train
    this step on their lanes (cfg.num_envs of them), averaging gradients
    and metrics (parallel.train_sharded)."""
    del model
    mb_size, mb_lanes = _check_geometry(cfg)
    batch = cfg.horizon * cfg.num_envs
    opt = Optimizer(cfg, mesh)
    n_steps = cfg.epochs * cfg.num_minibatches
    mark = phases(on_phase)
    cs = mb_size // cfg.grad_accum

    def train_step(runner: RunnerState):
        torch.backends.cuda.matmul.allow_tf32 = False
        mark("rollout")
        module = runner.params
        if getattr(module, "flat", None) is None:
            raise ValueError("the model's parameters are not flat: call "
                             "flatten_() (init_runner does)")
        if runner.env_state.n != cfg.num_envs:
            raise ValueError(f"the runner has {runner.env_state.n} lanes, "
                             f"the config {cfg.num_envs}")
        dev = module.flat.device
        perms = scan_permutations(runner, permutations, cfg,
                                  cfg.num_envs if mb_lanes else batch, dev)
        z = noise(runner) if noise is not None else None
        with scan_flags():
            final, last_obs, traj = collect(module, env, runner, cfg.horizon,
                                            z)
            mark("gae")
            with torch.no_grad():
                last_value = module(last_obs)[2]
            adv, ret = gae_normalized(traj, last_value, cfg, mesh)
            full = dict(obs=traj.obs, action=traj.action, logp=traj.logp,
                        value=traj.value, adv=adv, ret=ret)
            if mb_lanes is None:
                full = {k: v.reshape(batch, *v.shape[2:])
                        for k, v in full.items()}

            def loss_fn(mb):
                mean, log_std, value = module(mb["obs"])
                return ppo_loss(cfg, mean, log_std, value, mb)

            mark("update")
            per_step = torch.empty(n_steps, 1 + len(AUX_KEYS), device=dev)
            i = 0
            for e in range(cfg.epochs):
                for m in range(cfg.num_minibatches):
                    if mb_lanes is not None:
                        take = perms[e, m * mb_lanes:(m + 1) * mb_lanes]
                        mb = {k: v[:, take].reshape(mb_size, *v.shape[2:])
                              for k, v in full.items()}
                    else:
                        take = perms[e, m * mb_size:(m + 1) * mb_size]
                        mb = {k: v[take] for k, v in full.items()}
                    chunks = [{k: v[c * cs:(c + 1) * cs]
                               for k, v in mb.items()}
                              for c in range(cfg.grad_accum)]
                    per_step[i] = opt.step(runner, loss_fn, chunks)
                    i += 1
        mark("metrics")
        metrics = scan_metrics(traj, None, per_step, dev, mesh)
        runner2 = dataclasses.replace(runner, env_state=final,
                                      last_obs=last_obs,
                                      update_idx=runner.update_idx + 1)
        mark("end")
        return runner2, metrics

    return train_step
