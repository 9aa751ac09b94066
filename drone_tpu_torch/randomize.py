"""Reset randomization + per-episode domain randomization.

Counterpart of `drone_tpu/randomize.py`, with the same counter-based draw
layout per reset (episode e, blocks 0..RESET_BLOCKS-1; u[i] = uniform i):
    u0..u2   position offset in [-pos_radius, pos_radius] around p.target
    u3..u5   velocity in [-vel_max_init, vel_max_init]
    u6..u8   rotation vector in [-rot_max_init, rot_max_init]
    u9..u11  omega in [-omega_max_init, omega_max_init]
    u12      mass DR scale in [dr_mass_lo, dr_mass_hi]
    u13      thrust DR scale in [dr_thrust_lo, dr_thrust_hi]
    u14..u16 waypoint target (waypoint task only)
"""

from __future__ import annotations

import torch

from drone_tpu_torch import prng
from drone_tpu_torch.dynamics import sqrt_rn
from drone_tpu_torch.types import RESET_BLOCKS, WP_BLOCK0


def reset_draws(key0, key1, episode, n_blocks: int = RESET_BLOCKS):
    """The first 2*n_blocks uniforms of a reset, shaped (N, 2*n_blocks).
    Tasks other than waypoint use only the first 7 blocks."""
    return prng.episode_uniforms(key0, key1, episode, n_blocks)


def waypoint_draws(key0, key1, episode, wp_count):
    """3 uniforms for the wp_count-th mid-episode waypoint respawn (blocks
    WP_BLOCK0 + 2*wp_count and +1)."""
    j0 = (WP_BLOCK0 + prng.to_u32(wp_count) * 2) & 0xFFFFFFFF
    b0, b1 = prng.threefry2x32(key0, key1, episode, j0)
    b2, _ = prng.threefry2x32(key0, key1, episode, j0 + 1)
    return (prng.bits_to_uniform(b0), prng.bits_to_uniform(b1),
            prng.bits_to_uniform(b2))


def sample_waypoint(u0, u1, u2, p):
    """Waypoint target (N, 3) from 3 uniforms."""
    tx = (u0 * 2.0 - 1.0) * p.wp_box
    ty = (u1 * 2.0 - 1.0) * p.wp_box
    tz = p.wp_zmin + u2 * (p.wp_zmax - p.wp_zmin)
    return torch.stack([tx, ty, tz], 1)


def init_pose(u, p):
    """(pos, vel, quat, omega, dr_mass, dr_thrust) from reset uniforms u."""
    def centered(i, scale):
        return (u[:, i] * 2.0 - 1.0) * scale

    px = p.target[0] + centered(0, p.pos_radius)
    py = p.target[1] + centered(1, p.pos_radius)
    pz = p.target[2] + centered(2, p.pos_radius)
    vx = centered(3, p.vel_max_init)
    vy = centered(4, p.vel_max_init)
    vz = centered(5, p.vel_max_init)
    hx = centered(6, p.rot_max_init) * 0.5
    hy = centered(7, p.rot_max_init) * 0.5
    hz = centered(8, p.rot_max_init) * 0.5
    n2 = 1.0 + (hx * hx + hy * hy + hz * hz)
    n = sqrt_rn(n2)
    qw = 1.0 / n
    qx = hx / n
    qy = hy / n
    qz = hz / n
    wx = centered(9, p.omega_max_init)
    wy = centered(10, p.omega_max_init)
    wz = centered(11, p.omega_max_init)
    dr_mass = p.dr_mass_lo + u[:, 12] * (p.dr_mass_hi - p.dr_mass_lo)
    dr_thrust = p.dr_thrust_lo + u[:, 13] * (p.dr_thrust_hi - p.dr_thrust_lo)
    return (torch.stack([px, py, pz], 1), torch.stack([vx, vy, vz], 1),
            torch.stack([qw, qx, qy, qz], 1), torch.stack([wx, wy, wz], 1),
            dr_mass, dr_thrust)
