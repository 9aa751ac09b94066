"""Counter-based PRNG: Threefry-2x32 (20 rounds) on torch tensors.

Counterpart of `drone_tpu/prng.py`, with the same key discipline as it and
`oracle/drone_oracle.c`:
  lane_key(seed, lane)       = threefry2x32((seed, GOLDEN), (lane, 0))
  draw block j of episode e  = threefry2x32(lane_key, (e, j))  -> 2 uniforms
  uniform in [0, 1)          = bitcast(0x3F800000 | (bits >> 9)) - 1.0

torch has no uint32 add on the CPU, so words are carried as int64 tensors
holding values in [0, 2**32) and every sum is masked back to 32 bits. The
state stores uint32 fields as int32 bit patterns: `to_u32` widens them and
`from_u32` narrows back. The CUDA kernels use native `uint32_t`
(`csrc/env.cuh`). The numpy copies at the end make host-side action streams.
"""

from __future__ import annotations

import numpy as np
import torch

GOLDEN = 0x9E3779B9   # fixed second key word
_PARITY = 0x1BD11BDA  # threefry key-schedule parity constant
_MASK = 0xFFFFFFFF

# Rotation schedules for Threefry-2x32 (Random123).
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def to_u32(x, device=None) -> torch.Tensor:
    """int32 bit pattern (or int) -> int64 tensor holding the uint32 value."""
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 uint32 value -> int32 tensor with the same 32 bits."""
    x = x & _MASK
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 tensors holding uint32 values
    (broadcasting). KAT: key=0, ctr=0 -> (0x6b200159, 0x99ba4efe)."""
    k0, k1, x0, x1 = (to_u32(v) for v in (k0, k1, x0, x1))
    ks = (k0, k1, _PARITY ^ k0 ^ k1)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    rots = (_ROT_A, _ROT_B)
    for i in range(5):
        for r in rots[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64) -> float32 uniform in [0, 1). The mantissa word is
    below 2**31, so it fits int32 before the bitcast."""
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mantissa.view(torch.float32) - 1.0


def lane_key(seed, lane):
    """Per-lane key (two int64 uint32 words) from a global uint32 seed."""
    lane = to_u32(lane)
    return threefry2x32(to_u32(seed, lane.device), GOLDEN, lane, 0)


def episode_uniforms(key0, key1, episode, n_blocks: int):
    """`2*n_blocks` float32 uniforms per lane, shaped (..., 2*n_blocks):
    block j yields uniforms (2j, 2j+1). All blocks go through one batched
    threefry call."""
    key0, key1, episode = to_u32(key0), to_u32(key1), to_u32(episode)
    j = torch.arange(n_blocks, device=key0.device)
    j = j.reshape((n_blocks,) + (1,) * key0.dim())
    b0, b1 = threefry2x32(key0, key1, episode, j)
    u = torch.stack([bits_to_uniform(b0), bits_to_uniform(b1)], -1)
    # (n_blocks, ..., 2) -> (..., n_blocks, 2) -> (..., 2*n_blocks)
    return u.movedim(0, -2).reshape(key0.shape + (2 * n_blocks,))


# ---------------------------------------------------------------------------
# NumPy copies (host-side action streams and test fixtures).
# ---------------------------------------------------------------------------

def threefry2x32_np(k0, k1, x0, x1):
    """NumPy uint32 Threefry-2x32."""
    with np.errstate(over="ignore"):
        k0 = np.asarray(k0, np.uint32)
        k1 = np.asarray(k1, np.uint32)
        x0 = np.asarray(x0, np.uint32).copy()
        x1 = np.asarray(x1, np.uint32).copy()
        ks = (k0, k1, (np.uint32(_PARITY) ^ k0 ^ k1).astype(np.uint32))

        def rotl(x, r):
            return ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(np.uint32)

        x0 = (x0 + ks[0]).astype(np.uint32)
        x1 = (x1 + ks[1]).astype(np.uint32)
        rots = (_ROT_A, _ROT_B)
        for i in range(5):
            for r in rots[i % 2]:
                x0 = (x0 + x1).astype(np.uint32)
                x1 = rotl(x1, r)
                x1 = (x1 ^ x0).astype(np.uint32)
            x0 = (x0 + ks[(i + 1) % 3]).astype(np.uint32)
            x1 = (x1 + ks[(i + 2) % 3] + np.uint32(i + 1)).astype(np.uint32)
        return x0, x1


def bits_to_uniform_np(bits):
    mantissa = ((np.asarray(bits, np.uint32) >> np.uint32(9))
                | np.uint32(0x3F800000)).astype(np.uint32)
    return mantissa.view(np.float32) - np.float32(1.0)


def action_stream_np(T: int, n: int, seed: int = 7, scale: float = 0.3,
                     bias: float = -0.1) -> np.ndarray:
    """Deterministic float32 actions shaped (T, n, 4): block j of key
    (seed, 0x5EED) gives actions 2j and 2j+1 in row-major order. Same values
    as `tests/helpers.action_stream`, computed in one vectorized call."""
    total = T * n * 4
    blocks = np.arange((total + 1) // 2, dtype=np.uint32)
    b0, b1 = threefry2x32_np(seed, 0x5EED, blocks, 0)
    bits = np.stack([b0, b1], -1).reshape(-1)[:total]
    u = bits_to_uniform_np(bits)
    return ((u * 2 - 1) * scale + bias).astype(np.float32).reshape(T, n, 4)
