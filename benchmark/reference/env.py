"""Plain reference of the quadrotor env: a frozen copy of its semantics.

The batched env of the C oracle (https://github.com/tensaur/drone), as the
port states it: Threefry-2x32 lane streams, the reset draws, motor mixing,
rigid-body dynamics (Euler or RK4), the hover reward, crash and truncation,
and the branch-free auto-reset. One float32 rounding per operation in the
oracle's order, so that on the same actions it gives the same bits as the
program's env. It imports nothing of the program: the benchmark holds the
program to it.

State: a dict of tensors over a leading lane axis. uint32 words are carried
as int64 tensors holding values in [0, 2**32).
"""

from __future__ import annotations

import math

import torch

OBS_DIM = 13
ACT_DIM = 4
GOLDEN = 0x9E3779B9
_PARITY = 0x1BD11BDA
_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
RESET_BLOCKS = 7            # the hover task's reset: 14 uniforms
NOISE_BLOCK0 = 0x60000000   # exploration noise, blocks NOISE_BLOCK0 + 2 step
TWO_PI = 6.2831853071795864

# the oracle's float32 constants (hover task)
DEFAULTS = dict(
    mass=0.75, gravity=9.81, arm_l=0.08, thrust_max=4.6, torque_coef=0.016,
    inertia_x=0.0023, inertia_y=0.0023, inertia_z=0.004, drag_lin=0.10,
    drag_ang=0.003, dt=0.01, target=(0.0, 0.0, 1.5), bound=5.0,
    tilt_min=0.0, horizon=1000, c_vel=0.02, c_spin=0.01, c_act=0.01,
    crash_penalty=-10.0, pos_radius=1.0, vel_max_init=0.5,
    rot_max_init=0.5, omega_max_init=0.5, dr_mass_lo=1.0, dr_mass_hi=1.0,
    dr_thrust_lo=1.0, dr_thrust_hi=1.0)


def params(env_table: dict, device) -> dict:
    """The env constants of a config's [env] table (task, integrator and
    overrides) as 0-d float32 tensors on `device` (horizon an int)."""
    env_table = dict(env_table)
    task = env_table.pop("task", "hover")
    integrator = env_table.pop("integrator", "euler")
    if task != "hover":
        raise ValueError(f"the reference env holds the hover task only, "
                         f"got {task!r}")
    if integrator not in ("euler", "rk4"):
        raise ValueError(f"unknown integrator {integrator!r}")
    vals = dict(DEFAULTS)
    unknown = set(env_table) - set(vals)
    if unknown:
        raise ValueError(f"env overrides the reference does not hold: "
                         f"{sorted(unknown)}")
    vals.update(env_table)
    p = {k: torch.tensor(v, dtype=torch.float32, device=device)
         for k, v in vals.items() if k != "horizon"}
    p["horizon"] = int(vals["horizon"])
    p["integrator"] = integrator
    return p


# --- Threefry-2x32, 20 rounds -------------------------------------------------

def u32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK


def threefry(k0, k1, x0, x1):
    k0, k1, x0, x1 = (u32(v) for v in (k0, k1, x0, x1))
    ks = (k0, k1, _PARITY ^ k0 ^ k1)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1): 23 high bits under exponent 0."""
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


# --- reset ---------------------------------------------------------------------

def reset(key0, key1, episode, p) -> dict:
    """Fresh episode `episode` of each lane (keys and episode as uint32)."""
    j = torch.arange(RESET_BLOCKS, device=key0.device)[:, None]
    b0, b1 = threefry(key0, key1, episode, j)
    u = torch.stack([uniform(b0), uniform(b1)], -1)      # (blocks, N, 2)
    u = u.movedim(0, -2).reshape(key0.shape[0], 2 * RESET_BLOCKS)

    def centered(i, scale):
        return (u[:, i] * 2.0 - 1.0) * scale

    tgt = p["target"]
    pos = torch.stack([tgt[k] + centered(k, p["pos_radius"])
                       for k in range(3)], 1)
    vel = torch.stack([centered(3 + k, p["vel_max_init"])
                       for k in range(3)], 1)
    hx, hy, hz = (centered(6 + k, p["rot_max_init"]) * 0.5 for k in range(3))
    n = sqrt_rn(1.0 + (hx * hx + hy * hy + hz * hz))
    quat = torch.stack([1.0 / n, hx / n, hy / n, hz / n], 1)
    omega = torch.stack([centered(9 + k, p["omega_max_init"])
                         for k in range(3)], 1)
    dr_mass = p["dr_mass_lo"] + u[:, 12] * (p["dr_mass_hi"] - p["dr_mass_lo"])
    dr_thrust = (p["dr_thrust_lo"]
                 + u[:, 13] * (p["dr_thrust_hi"] - p["dr_thrust_lo"]))
    zero = torch.zeros(key0.shape[0], dtype=torch.int64, device=key0.device)
    return dict(pos=pos, vel=vel, quat=quat, omega=omega,
                target=tgt.expand(key0.shape[0], 3), dr_mass=dr_mass,
                dr_thrust=dr_thrust, ep_return=torch.zeros_like(dr_mass),
                step=zero,
                episode=u32(episode, key0.device).expand(key0.shape).clone(),
                key0=key0, key1=key1)


def init(seed: int, n: int, p, device) -> dict:
    """Episode 0 of lanes 0 .. n - 1 under `seed`."""
    lanes = torch.arange(n, dtype=torch.int64, device=device)
    k0, k1 = threefry(u32(seed, device), GOLDEN, lanes, 0)
    return reset(k0, k1, 0, p)


def observe(s: dict) -> torch.Tensor:
    """(N, 13): target - pos, quat, vel, omega."""
    return torch.cat([s["target"] - s["pos"], s["quat"], s["vel"],
                      s["omega"]], 1)


def gauss4(s: dict) -> torch.Tensor:
    """(N, 4) standard normals of the lane's exploration stream: Box-Muller
    over blocks NOISE_BLOCK0 + 2 step (+1) of its current episode."""
    jb = NOISE_BLOCK0 + 2 * s["step"]
    b0, b1 = threefry(s["key0"], s["key1"], s["episode"], jb)
    b2, b3 = threefry(s["key0"], s["key1"], s["episode"], jb + 1)
    u1, u2, u3, u4 = (uniform(b) for b in (b0, b1, b2, b3))
    r1 = sqrt_rn(-2.0 * torch.log(1.0 - u1))
    r2 = sqrt_rn(-2.0 * torch.log(1.0 - u3))
    a1, a2 = TWO_PI * u2, TWO_PI * u4
    return torch.stack([r1 * torch.cos(a1), r1 * torch.sin(a1),
                        r2 * torch.cos(a2), r2 * torch.sin(a2)], 1)


# --- dynamics ------------------------------------------------------------------

def _deriv(vel, quat, omega, F, mass, p):
    F0, F1, F2, F3 = F.unbind(1)
    T = F0 + F1 + F2 + F3
    qw, qx, qy, qz = quat.unbind(1)
    uzx = 2.0 * (qx * qz + qw * qy)
    uzy = 2.0 * (qy * qz - qw * qx)
    uzz = 1.0 - 2.0 * (qx * qx + qy * qy)
    vx, vy, vz = vel.unbind(1)
    Tm = T / mass
    acc = torch.stack([Tm * uzx - p["drag_lin"] * vx / mass,
                       Tm * uzy - p["drag_lin"] * vy / mass,
                       Tm * uzz - p["drag_lin"] * vz / mass - p["gravity"]], 1)
    wx, wy, wz = omega.unbind(1)
    Ix, Iy, Iz = p["inertia_x"], p["inertia_y"], p["inertia_z"]
    tx = p["arm_l"] * ((F1 + F3) - (F0 + F2)) - p["drag_ang"] * wx
    ty = p["arm_l"] * ((F2 + F3) - (F0 + F1)) - p["drag_ang"] * wy
    tz = p["torque_coef"] * ((F1 + F2) - (F0 + F3)) - p["drag_ang"] * wz
    dw = torch.stack([(tx - (wy * (Iz * wz) - wz * (Iy * wy))) / Ix,
                      (ty - (wz * (Ix * wx) - wx * (Iz * wz))) / Iy,
                      (tz - (wx * (Iy * wy) - wy * (Ix * wx))) / Iz], 1)
    s = qx * wx + qy * wy + qz * wz
    dq = torch.stack([-0.5 * s,
                      0.5 * (qw * wx + qy * wz - qz * wy),
                      0.5 * (qw * wy - qx * wz + qz * wx),
                      0.5 * (qw * wz + qx * wy - qy * wx)], 1)
    return vel, acc, dq, dw


def _unit(q):
    qw, qx, qy, qz = q.unbind(1)
    n = sqrt_rn(qw * qw + qx * qx + qy * qy + qz * qz)
    return torch.stack([qw / n, qx / n, qy / n, qz / n], 1)


def _integrate(s, F, mass, p):
    x = (s["pos"], s["vel"], s["quat"], s["omega"])
    dt = p["dt"]
    if p["integrator"] == "euler":
        k = _deriv(*x[1:], F, mass, p)
        out = [a + dt * b for a, b in zip(x, k)]
    else:
        h2, h6 = dt * 0.5, dt * (1.0 / 6.0)
        k1 = _deriv(*x[1:], F, mass, p)
        k2 = _deriv(*[a + h2 * b for a, b in zip(x, k1)][1:], F, mass, p)
        k3 = _deriv(*[a + h2 * b for a, b in zip(x, k2)][1:], F, mass, p)
        k4 = _deriv(*[a + dt * b for a, b in zip(x, k3)][1:], F, mass, p)
        out = [a + h6 * (((b + 2.0 * c) + 2.0 * d) + e)
               for a, b, c, d, e in zip(x, k1, k2, k3, k4)]
    out[2] = _unit(out[2])
    return out


def step(s: dict, action: torch.Tensor, p):
    """One step of every lane. Returns (next state, reward, done, the
    finished episode's return where done else 0, its length where done
    else 0)."""
    f = torch.clamp_max(torch.clamp_min((action + 1.0) * 0.5, 0.0), 1.0)
    F = f * p["thrust_max"] * s["dr_thrust"][:, None]
    pos, vel, quat, omega = _integrate(s, F, p["mass"] * s["dr_mass"], p)
    d = s["target"] - pos
    r = 1.0 / (1.0 + (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]))
    r = r - p["c_vel"] * (vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1]
                          + vel[:, 2] * vel[:, 2])
    r = r - p["c_spin"] * (omega[:, 0] * omega[:, 0] + omega[:, 1] * omega[:, 1]
                           + omega[:, 2] * omega[:, 2])
    r = r - p["c_act"] * (action[:, 0] * action[:, 0]
                          + action[:, 1] * action[:, 1]
                          + action[:, 2] * action[:, 2]
                          + action[:, 3] * action[:, 3])
    upz = 1.0 - 2.0 * (quat[:, 1] * quat[:, 1] + quat[:, 2] * quat[:, 2])
    crashed = ((pos[:, 2] < 0.0) | (upz < p["tilt_min"])
               | (torch.abs(pos[:, 0]) > p["bound"])
               | (torch.abs(pos[:, 1]) > p["bound"]) | (pos[:, 2] > p["bound"]))
    step2 = s["step"] + 1
    done = crashed | (step2 >= p["horizon"])
    r = torch.where(crashed, r + p["crash_penalty"], r)
    ret = s["ep_return"] + r
    fresh = reset(s["key0"], s["key1"], (s["episode"] + 1) & _MASK, p)
    cont = dict(s, pos=pos, vel=vel, quat=quat, omega=omega, ep_return=ret,
                step=step2)
    nxt = {k: torch.where(done.reshape(-1, *([1] * (v.dim() - 1))),
                          fresh[k], v) if k in fresh else v
           for k, v in cont.items()}
    return (nxt, r, done, torch.where(done, ret, 0.0),
            torch.where(done, step2, 0))


def gaussian_logp(action, mean, log_std):
    """Log-density of a diagonal Gaussian, summed over the 4 motors."""
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * (z * z) - log_std - 0.5 * math.log(2.0 * math.pi),
                     dim=-1)
