"""DroneEnv: the batched, branch-free environment step.

Counterpart of `drone_tpu/env.py`: mix -> integrate -> reward ->
termination -> auto-reset -> observe, on a leading lane axis where JAX
vmapped one drone. PARITY CONTRACT: `reset_state` and `step` match
`oracle/drone_oracle.c` (drone_reset / drone_step) and `drone_tpu.env`
bitwise at float32 — same arithmetic order, same counter-based draws, same
auto-reset semantics (the obs returned after a done step is the new
episode's first obs).
"""

from __future__ import annotations

import torch

from drone_tpu_torch import dynamics, mixing, prng, randomize, tasks
from drone_tpu_torch.types import (
    ACT_DIM,
    OBS_DIM,
    EnvParams,
    EnvState,
    EnvStatics,
    StepOut,
    default_params,
    resolve_device,
)


def reset_state(key0, key1, episode, p: EnvParams,
                statics: EnvStatics) -> EnvState:
    """Fresh episode state per lane. key0/key1/episode are uint32 values
    (int64 or int32 bit patterns) broadcast to the lane axis."""
    key0, key1 = prng.to_u32(key0), prng.to_u32(key1)
    episode = prng.to_u32(episode, key0.device).expand(key0.shape)
    u = randomize.reset_draws(key0, key1, episode,
                              9 if statics.task == "waypoint" else 7)
    pos, vel, quat, omega, dr_mass, dr_thrust = randomize.init_pose(u, p)

    n = key0.shape[0]
    if statics.task == "hover":
        target = p.target.expand(n, 3)
    elif statics.task == "waypoint":
        target = randomize.sample_waypoint(u[:, 14], u[:, 15], u[:, 16], p)
    else:  # racing
        target = p.gates[0].expand(n, 3)

    zero_i = torch.zeros(n, dtype=torch.int32, device=key0.device)
    return EnvState(
        pos=pos,
        vel=vel,
        quat=quat,
        omega=omega,
        target=target,
        dr_mass=dr_mass,
        dr_thrust=dr_thrust,
        ep_return=torch.zeros(n, dtype=torch.float32, device=key0.device),
        step=zero_i,
        reset_count=prng.from_u32(episode),
        wp_count=zero_i,
        gate_idx=zero_i,
        key0=prng.from_u32(key0),
        key1=prng.from_u32(key1),
    )


def init_state(seed, lanes: torch.Tensor, p: EnvParams, statics: EnvStatics,
               episode=0) -> EnvState:
    """Episode-`episode` state of each lane in `lanes` under global `seed`."""
    k0, k1 = prng.lane_key(seed, lanes)
    return reset_state(k0, k1, episode, p, statics)


def observe(state: EnvState) -> torch.Tensor:
    return tasks.observation(state.pos, state.vel, state.quat, state.omega,
                             state.target)


def _step_continued(state: EnvState, action, p: EnvParams, statics: EnvStatics):
    """Physics + task + termination, without the auto-reset select.
    Returns (continued_state, reward, crashed, truncated, done)."""
    mass_eff = p.mass * state.dr_mass
    thrusts = mixing.mix(action, p, state.dr_thrust)

    integrate = (dynamics.euler_step if statics.integrator == "euler"
                 else dynamics.rk4_step)
    pos2, vel2, quat2, omega2 = integrate(state.pos, state.vel, state.quat,
                                          state.omega, thrusts, mass_eff, p)

    step2 = state.step + 1
    r, d2 = tasks.reward_base(pos2, vel2, omega2, action, state.target, p)

    target2 = state.target
    wp_count2 = state.wp_count
    gate_idx2 = state.gate_idx
    if statics.task == "waypoint":
        reached = d2 < p.reach_tol2
        r = torch.where(reached, r + p.reach_bonus, r)
        w0, w1, w2 = randomize.waypoint_draws(
            state.key0, state.key1, state.reset_count, state.wp_count)
        new_target = randomize.sample_waypoint(w0, w1, w2, p)
        target2 = torch.where(reached[:, None], new_target, state.target)
        wp_count2 = state.wp_count + reached.to(torch.int32)
    elif statics.task == "racing":
        reached = d2 < p.reach_tol2
        r = torch.where(reached, r + p.reach_bonus, r)
        # max(n_gates, 1) mirrors the C oracle's SIGFPE guard
        gate_next = torch.remainder(state.gate_idx + 1,
                                    torch.clamp_min(p.n_gates, 1))
        gate_idx2 = torch.where(reached, gate_next, state.gate_idx)
        target2 = p.gates[gate_idx2.long()]
        wp_count2 = state.wp_count + reached.to(torch.int32)

    crashed = tasks.check_crash(pos2, quat2, p)
    truncated = (step2 >= p.horizon) & ~crashed
    done = crashed | truncated
    r = torch.where(crashed, r + p.crash_penalty, r)
    ep_return2 = state.ep_return + r

    continued = EnvState(
        pos=pos2,
        vel=vel2,
        quat=quat2,
        omega=omega2,
        target=target2,
        dr_mass=state.dr_mass,
        dr_thrust=state.dr_thrust,
        ep_return=ep_return2,
        step=step2,
        reset_count=state.reset_count,
        wp_count=wp_count2,
        gate_idx=gate_idx2,
        key0=state.key0,
        key1=state.key1,
    )
    return continued, r, crashed, truncated, done


def _finish_step(continued, r, crashed, truncated, done, p, statics):
    """Auto-reset select + StepOut packing (shared by step and
    step_terminal)."""
    fresh = reset_state(continued.key0, continued.key1,
                        prng.to_u32(continued.reset_count) + 1, p, statics)
    next_state = fresh.select(done, continued)
    out = StepOut(
        obs=observe(next_state),
        reward=r,
        terminated=crashed,
        truncated=truncated,
        ep_return=torch.where(done, continued.ep_return, 0.0),
        ep_length=torch.where(done, continued.step, 0),
    )
    return next_state, out


def step(state: EnvState, action, p: EnvParams, statics: EnvStatics):
    """One env step for every lane. Returns (next_state, StepOut).

    Branch-free: the auto-reset state is always computed (counter-based RNG
    makes this side-effect free) and selected per lane."""
    return _finish_step(*_step_continued(state, action, p, statics), p,
                        statics)


def step_terminal(state: EnvState, action, p: EnvParams, statics: EnvStatics):
    """Like `step`, and also returns the observation of the terminal
    (pre-auto-reset) state, what Gymnasium calls the final observation:
    (next_state, StepOut, terminal_obs). The adapters of `emulation` and
    `multiagent` use it."""
    continued, *rest = _step_continued(state, action, p, statics)
    next_state, out = _finish_step(continued, *rest, p, statics)
    return next_state, out, observe(continued)


class DroneEnv:
    """Statics + params on one device, with single-lane helpers (a batch of
    one lane) and batched ones."""

    def __init__(self, task: str = "hover", integrator: str = "euler",
                 params: EnvParams | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.statics = EnvStatics(task=task, integrator=integrator)
        self.params = (params if params is not None
                       else default_params(task)).to(self.device)

    # single-lane API: a batch of one lane ------------------------------------
    def init(self, seed, lane=0, params: EnvParams | None = None) -> EnvState:
        p = self.params if params is None else params
        lanes = torch.tensor([lane], dtype=torch.int64, device=self.device)
        return init_state(seed, lanes, p, self.statics)

    def step(self, state: EnvState, action, params: EnvParams | None = None):
        p = self.params if params is None else params
        action = torch.as_tensor(action, dtype=torch.float32,
                                 device=self.device).reshape(state.n, ACT_DIM)
        return step(state, action, p, self.statics)

    def observe(self, state: EnvState) -> torch.Tensor:
        return observe(state)

    # batched API --------------------------------------------------------------
    def init_batch(self, seed, n: int, params: EnvParams | None = None,
                   episode: int = 0, first_lane: int = 0) -> EnvState:
        """Lanes first_lane .. first_lane + n - 1 of the batch under `seed`:
        a rank's shard of a larger batch is bitwise those lanes of it."""
        p = self.params if params is None else params
        lanes = torch.arange(first_lane, first_lane + n, dtype=torch.int64,
                             device=self.device)
        return init_state(seed, lanes, p, self.statics, episode)

    def step_batch(self, state: EnvState, actions,
                   params: EnvParams | None = None):
        p = self.params if params is None else params
        return step(state, actions, p, self.statics)

    def observe_batch(self, state: EnvState) -> torch.Tensor:
        return observe(state)

    @property
    def obs_dim(self) -> int:
        return OBS_DIM

    @property
    def act_dim(self) -> int:
        return ACT_DIM
