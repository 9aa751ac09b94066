"""Task logic: reward shaping, crash/termination, observation.

Counterpart of `drone_tpu/tasks.py`, batched over a leading lane axis.
Expression order mirrors `oracle/drone_oracle.c` exactly:
    r = 1/(1 + d2) - c_vel*|v|^2 - c_spin*|w|^2 - c_act*|a|^2
"""

from __future__ import annotations

import torch


def reward_base(pos, vel, omega, action, target, p):
    """Dense shaping reward; returns (reward, squared distance to target)."""
    dx = target[:, 0] - pos[:, 0]
    dy = target[:, 1] - pos[:, 1]
    dz = target[:, 2] - pos[:, 2]
    d2 = dx * dx + dy * dy + dz * dz
    r = 1.0 / (1.0 + d2)
    v2 = vel[:, 0] * vel[:, 0] + vel[:, 1] * vel[:, 1] + vel[:, 2] * vel[:, 2]
    r = r - p.c_vel * v2
    w2 = (omega[:, 0] * omega[:, 0] + omega[:, 1] * omega[:, 1]
          + omega[:, 2] * omega[:, 2])
    r = r - p.c_spin * w2
    a2 = (action[:, 0] * action[:, 0] + action[:, 1] * action[:, 1]
          + action[:, 2] * action[:, 2] + action[:, 3] * action[:, 3])
    r = r - p.c_act * a2
    return r, d2


def check_crash(pos, quat, p):
    """Crash = hit ground, excessive tilt, or out of bounds."""
    upz = 1.0 - 2.0 * (quat[:, 1] * quat[:, 1] + quat[:, 2] * quat[:, 2])
    crashed = pos[:, 2] < 0.0
    crashed = crashed | (upz < p.tilt_min)
    crashed = crashed | (torch.abs(pos[:, 0]) > p.bound)
    crashed = crashed | (torch.abs(pos[:, 1]) > p.bound)
    crashed = crashed | (pos[:, 2] > p.bound)
    return crashed


def observation(pos, vel, quat, omega, target):
    """(N, OBS_DIM) = target-relative position, quat, vel, omega (all raw)."""
    return torch.cat([target - pos, quat, vel, omega], 1)
