"""Observation and action space declarations.

Counterpart of `drone_tpu/spaces.py`: a 13-dim unbounded Box observation
(target-relative position, quaternion, linear and angular velocity) and a
4-dim [-1, 1] Box action (one command per rotor).

Uses gymnasium.spaces when gymnasium is installed, so the adapters of
`emulation` interoperate with the wider ecosystem, and otherwise a minimal
structural `Box` with the same attribute names: the package never needs
gymnasium.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from drone_tpu_torch.types import ACT_DIM, OBS_DIM

try:  # pragma: no cover - exercised whenever gymnasium is installed
    import gymnasium.spaces as _gym_spaces
except ImportError:  # pragma: no cover
    _gym_spaces = None


@dataclasses.dataclass(frozen=True)
class Box:
    """Minimal stand-in for gymnasium.spaces.Box (same attribute names)."""

    low: np.ndarray
    high: np.ndarray
    shape: tuple
    dtype: type = np.float32

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return (
            x.shape == self.shape
            and bool(np.all(x >= self.low))
            and bool(np.all(x <= self.high))
        )

    def sample(self, rng: np.random.Generator | None = None) -> np.ndarray:
        rng = rng or np.random.default_rng()
        lo = np.where(np.isfinite(self.low), self.low, -1.0)
        hi = np.where(np.isfinite(self.high), self.high, 1.0)
        return rng.uniform(lo, hi).astype(self.dtype)


def _box(low, high, shape):
    if _gym_spaces is not None:
        return _gym_spaces.Box(low=low, high=high, shape=shape, dtype=np.float32)
    return Box(
        low=np.full(shape, low, np.float32),
        high=np.full(shape, high, np.float32),
        shape=shape,
    )


def observation_space():
    """(OBS_DIM,) float32, unbounded."""
    return _box(-np.inf, np.inf, (OBS_DIM,))


def action_space():
    """(ACT_DIM,) float32 in [-1, 1]: one normalized command per rotor."""
    return _box(-1.0, 1.0, (ACT_DIM,))
