"""Pixel observations: the camera-view drone variant (counterpart of
`drone_tpu/pixels.py`).

A compact body-frame sensor image rendered from the 13-float observation,
four Gaussian splats on a res x res grid:

  channel 0 - the target direction in the body frame, amplitude
              1 / (1 + distance);
  channel 1 - the world up-vector in the body frame (attitude), amplitude
              0.5 + 0.5 * up_z;
  channel 2 - the body-frame velocity, amplitude speed / (1 + speed);
  channel 3 - the body rates omega, amplitude |omega| / (1 + |omega|).

`obs_to_pixels` renders the image the module path convolves
(`models.cnn.PatchCNNActorCritic`); the CNN kernels and their plain
versions never store it and re-render each conv0 patch from the 12 splat
scalars per lane (`ops.cuda_acting_cnn.splat_planes`, `render_patch`).

The pixel coordinates come from one table, `patch_grid`, built on the host
with the reference's float32 `jnp.linspace` arithmetic, so both layouts
(image and patch-major rows) and every consumer read the same bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from drone_tpu_torch.dynamics import sqrt_rn
from drone_tpu_torch.types import OBS_DIM

SPLAT_SIGMA = 0.18  # Gaussian splat width (the CNN kernels' render too)


@functools.lru_cache(maxsize=None)
def linspace_np(res: int) -> np.ndarray:
    """float32 jnp.linspace(-1, 1, res) bit for bit as the reference's CPU
    tier computes it: step = iota * float32(1 / (res - 1)) (XLA turns the
    division by a constant into a reciprocal multiply), out = start * (1 -
    step) + stop * step, the endpoint set to stop."""
    f = np.float32
    if res < 2:
        return np.full(res, f(-1.0))
    step = np.arange(res - 1, dtype=f) * (f(1.0) / f(res - 1))
    out = f(-1.0) * (f(1.0) - step) + f(1.0) * step
    return np.concatenate([out.astype(f), [f(1.0)]]).astype(f)


@functools.lru_cache(maxsize=None)
def _patch_grid_np(res: int, patch: int):
    lin = linspace_np(res)
    g = res // patch
    s = np.arange(patch * patch)
    q = np.arange(g * g)
    di, dj = s // patch, s % patch
    qi, qj = q // g, q % g
    i = (qi[:, None] * patch + di[None, :]).reshape(-1)
    j = (qj[:, None] * patch + dj[None, :]).reshape(-1)
    return lin[j].copy(), lin[i].copy()


_tables: dict = {}


def device_table(key, make, device) -> torch.Tensor:
    """A constant table (make() -> numpy array) on `device`, made once per
    key and device. To a card it goes through pinned memory, so the copy
    queues on the stream instead of waiting for it (a pageable copy would
    sync the host inside a train step)."""
    device = torch.device(device)
    k = (key, str(device))
    if k not in _tables:
        t = torch.from_numpy(np.array(make()))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        _tables[k] = t
    return _tables[k]


def grid_table(res: int, patch: int, device="cpu") -> torch.Tensor:
    """patch_grid's (gx, gy) as one contiguous (2, res^2) tensor (the CNN
    kernels read it so)."""
    return device_table(("patch_grid", res, patch),
                        lambda: np.stack(_patch_grid_np(res, patch)), device)


def patch_grid(res: int, patch: int, device="cpu"):
    """Pixel-coordinate columns in the CNN kernels' patch-major row order:
    (gx, gy), each (res * res,) float32, where row r = q * patch^2 + s holds
    within-patch offset s = di * patch + dj of patch q = qi * (res // patch)
    + qj (pixel i = qi * patch + di, j = qj * patch + dj). gx varies along
    the image's x axis (j), gy along y (i)."""
    grid = grid_table(res, patch, device)
    return grid[0], grid[1]


def body_rotation_t(quat):
    """Rows of R^T for q = (w, x, y, z) (world -> body): three (..., 3)."""
    w, x, y, z = quat.unbind(-1)
    r0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y + w * z),
                      2 * (x * z - w * y)], -1)
    r1 = torch.stack([2 * (x * y - w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z + w * x)], -1)
    r2 = torch.stack([2 * (x * z + w * y), 2 * (y * z - w * x),
                      1 - 2 * (x * x + y * y)], -1)
    return r0, r1, r2


def _dot3(r, v):
    p = r * v
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def to_body(quat, v):
    """Rotate world vectors (..., 3) into the body frame."""
    r0, r1, r2 = body_rotation_t(quat)
    return torch.stack([_dot3(r0, v), _dot3(r1, v), _dot3(r2, v)], -1)


def splat_inputs(obs):
    """(..., OBS_DIM) obs -> ((u0, u1, amp) per channel, each (...,)): the 12
    scalars obs_to_pixels renders from."""
    rel, quat, vel, omega = obs[..., 0:3], obs[..., 3:7], obs[..., 7:10], \
        obs[..., 10:13]
    up = torch.zeros_like(rel)
    up[..., 2] = 1.0
    rel_b, vel_b = to_body(quat, rel), to_body(quat, vel)
    up_b = to_body(quat, up)
    one = torch.ones((), dtype=obs.dtype, device=obs.device)

    def dir2(v):
        n = sqrt_rn(_dot3(v, v))
        return v[..., :2] / (one + n)[..., None], n

    u_t, d_t = dir2(rel_b)
    u_v, d_v = dir2(vel_b)
    u_w, d_w = dir2(omega)  # omega is already in the body frame
    return ((u_t[..., 0], u_t[..., 1], one / (one + d_t)),
            (up_b[..., 0], up_b[..., 1], 0.5 + 0.5 * up_b[..., 2]),
            (u_v[..., 0], u_v[..., 1], d_v / (one + d_v)),
            (u_w[..., 0], u_w[..., 1], d_w / (one + d_w)))


def _splat(u0, u1, amp, res, sigma=SPLAT_SIGMA):
    """Centers (...,) in [-1, 1] and amplitudes (...,) -> (..., res, res)."""
    lin = device_table(("linspace", res), lambda: linspace_np(res), u0.device)
    gx, gy = lin[None, :], lin[:, None]
    d2 = (gx - u0[..., None, None]) ** 2 + (gy - u1[..., None, None]) ** 2
    den = torch.full((), 2.0 * sigma * sigma, dtype=torch.float32,
                     device=u0.device)
    return amp[..., None, None] * torch.exp(-d2 / den)


def obs_to_pixels(obs, res: int = 24):
    """(..., OBS_DIM) observations -> (..., res, res, 4) images."""
    if obs.shape[-1] != OBS_DIM:
        raise ValueError(f"observations are (..., {OBS_DIM}), got "
                         f"{tuple(obs.shape)}")
    return torch.stack([_splat(u0, u1, amp, res)
                        for u0, u1, amp in splat_inputs(obs)], -1)
