"""Quadrotor rigid-body 6-DoF dynamics: derivative + Euler / RK4 integrators.

Counterpart of `drone_tpu/dynamics.py`, batched over a leading lane axis.
PARITY CONTRACT: every expression keeps the evaluation order of
`drone_tpu/dynamics.py` and `oracle/drone_oracle.c`, one rounding per
operation, so the float32 results match them bitwise. No fused ops
(addcmul, lerp, addmm). sqrt is taken in float64 and rounded to float32:
`torch.sqrt` on float32 is not correctly rounded on the CPU, and a double
square root rounded once to float32 is.

Rotor layout (X configuration, x forward / y left / z up, thrusts F0..F3):
  roll  tau_x = arm_l * ((F1 + F3) - (F0 + F2))
  pitch tau_y = arm_l * ((F2 + F3) - (F0 + F1))
  yaw   tau_z = torque_coef * ((F1 + F2) - (F0 + F3))
"""

from __future__ import annotations

import torch

# 1/6 rounded to float32, the constant `drone_tpu` gets from weak typing
# (and C from 1.0f / 6.0f): h6 = dt * SIXTH, never dt / 6.
SIXTH = 1.0 / 6.0


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


def deriv(pos, vel, quat, omega, thrusts, mass_eff, p):
    """Time derivative of (pos, vel, quat, omega), each (N, k)."""
    del pos
    F0, F1, F2, F3 = thrusts.unbind(1)
    T = F0 + F1 + F2 + F3

    qw, qx, qy, qz = quat.unbind(1)
    uzx = 2.0 * (qx * qz + qw * qy)
    uzy = 2.0 * (qy * qz - qw * qx)
    uzz = 1.0 - 2.0 * (qx * qx + qy * qy)

    vx, vy, vz = vel.unbind(1)
    Tm = T / mass_eff
    ax = Tm * uzx - p.drag_lin * vx / mass_eff
    ay = Tm * uzy - p.drag_lin * vy / mass_eff
    az = Tm * uzz - p.drag_lin * vz / mass_eff - p.gravity

    wx, wy, wz = omega.unbind(1)
    taux = p.arm_l * ((F1 + F3) - (F0 + F2)) - p.drag_ang * wx
    tauy = p.arm_l * ((F2 + F3) - (F0 + F1)) - p.drag_ang * wy
    tauz = p.torque_coef * ((F1 + F2) - (F0 + F3)) - p.drag_ang * wz
    wdx = (taux - (wy * (p.inertia_z * wz) - wz * (p.inertia_y * wy))) / p.inertia_x
    wdy = (tauy - (wz * (p.inertia_x * wx) - wx * (p.inertia_z * wz))) / p.inertia_y
    wdz = (tauz - (wx * (p.inertia_y * wy) - wy * (p.inertia_x * wx))) / p.inertia_z

    s = qx * wx + qy * wy + qz * wz
    qdw = -0.5 * s
    qdx = 0.5 * (qw * wx + qy * wz - qz * wy)
    qdy = 0.5 * (qw * wy - qx * wz + qz * wx)
    qdz = 0.5 * (qw * wz + qx * wy - qy * wx)

    return (vel, torch.stack([ax, ay, az], 1),
            torch.stack([qdw, qdx, qdy, qdz], 1),
            torch.stack([wdx, wdy, wdz], 1))


def normalize_quat(quat):
    """Renormalize (w,x,y,z). Mirrors oracle drone_quat_normalize."""
    qw, qx, qy, qz = quat.unbind(1)
    n2 = qw * qw + qx * qx + qy * qy + qz * qz
    n = sqrt_rn(n2)
    return torch.stack([qw / n, qx / n, qy / n, qz / n], 1)


def euler_step(pos, vel, quat, omega, thrusts, mass_eff, p):
    """One explicit Euler step; quat renormalized."""
    dpos, dvel, dquat, domega = deriv(pos, vel, quat, omega, thrusts,
                                      mass_eff, p)
    pos2 = pos + p.dt * dpos
    vel2 = vel + p.dt * dvel
    quat2 = quat + p.dt * dquat
    omega2 = omega + p.dt * domega
    return pos2, vel2, normalize_quat(quat2), omega2


def rk4_step(pos, vel, quat, omega, thrusts, mass_eff, p):
    """Classic RK4 (thrusts held over the step); quat renormalized at the
    end only. Combination order: s + h6*(((k1 + 2*k2) + 2*k3) + k4)."""
    h2 = p.dt * 0.5
    h6 = p.dt * SIXTH
    s = (pos, vel, quat, omega)

    k1 = deriv(*s, thrusts, mass_eff, p)
    k2 = deriv(*(x + h2 * k for x, k in zip(s, k1)), thrusts, mass_eff, p)
    k3 = deriv(*(x + h2 * k for x, k in zip(s, k2)), thrusts, mass_eff, p)
    k4 = deriv(*(x + p.dt * k for x, k in zip(s, k3)), thrusts, mass_eff, p)
    pos2, vel2, quat2, omega2 = (
        x + h6 * (((a + 2.0 * b) + 2.0 * c) + d)
        for x, a, b, c, d in zip(s, k1, k2, k3, k4))
    return pos2, vel2, normalize_quat(quat2), omega2
