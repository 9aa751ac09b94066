"""drone_tpu_torch.prng against drone_tpu.prng: Threefry-2x32 bitwise.

The torch port carries uint32 words in int64 tensors (torch has no uint32
add on the CPU); these tests hold it bitwise to the JAX generator and the
numpy copies across lane keys and every counter range the env uses.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from drone_tpu import prng as jprng
from drone_tpu.types import WP_BLOCK0
from drone_tpu_torch import prng
from tests.helpers import action_stream

SEEDS = (0, 42, 0xFFFFFFFF)
LANES = np.arange(64, dtype=np.uint32)
EPISODES = np.array([0, 1, 77, 2**31, 2**32 - 1], np.uint32)

# counter blocks of each stream: reset 0..8, waypoint respawn
# WP_BLOCK0 + 2*wp (+1), in-kernel actions 0x40000000 + 2*step (+1),
# exploration noise 0x60000000 + 2*step (+1)
BLOCKS = {
    "reset": np.arange(9, dtype=np.uint32),
    "waypoint": np.array([WP_BLOCK0 + 2 * w + d for w in (0, 1, 5, 2**31 - 9)
                          for d in (0, 1)], np.uint32),
    "actions": np.array([0x40000000 + 2 * s + d for s in (0, 1, 999, 2**29)
                         for d in (0, 1)], np.uint32),
    "noise": np.array([0x60000000 + 2 * s + d for s in (0, 1, 999, 2**28)
                       for d in (0, 1)], np.uint32),
}


def test_known_answer():
    x0, x1 = prng.threefry2x32(0, 0, 0, 0)
    assert (int(x0), int(x1)) == (0x6B200159, 0x99BA4EFE)
    n0, n1 = prng.threefry2x32_np(0, 0, 0, 0)
    assert (int(n0), int(n1)) == (0x6B200159, 0x99BA4EFE)


@pytest.mark.parametrize("stream", sorted(BLOCKS))
def test_threefry_bitwise_vs_jax(stream):
    blocks = BLOCKS[stream]
    for seed in SEEDS:
        jk0, jk1 = jprng.lane_key(seed, jnp.asarray(LANES))
        tk0, tk1 = prng.lane_key(seed, torch.from_numpy(LANES.astype(np.int64)))
        np.testing.assert_array_equal(np.asarray(jk0), tk0.numpy())
        np.testing.assert_array_equal(np.asarray(jk1), tk1.numpy())
        # every (lane, episode, block) combination
        k0 = np.asarray(jk0)[:, None, None]
        k1 = np.asarray(jk1)[:, None, None]
        e = EPISODES[None, :, None]
        b = blocks[None, None, :]
        j0, j1 = jprng.threefry2x32(k0, k1, e, b)
        t0, t1 = prng.threefry2x32(*(torch.from_numpy(a.astype(np.int64))
                                     for a in (k0, k1, e, b)))
        n0, n1 = prng.threefry2x32_np(k0, k1, e, b)
        for want, got_t, got_n in ((j0, t0, n0), (j1, t1, n1)):
            want = np.asarray(want)
            np.testing.assert_array_equal(want.astype(np.int64), got_t.numpy())
            np.testing.assert_array_equal(want, got_n)
        u_j = np.asarray(jprng.bits_to_uniform(j0)).view(np.uint32)
        u_t = prng.bits_to_uniform(t0).numpy().view(np.uint32)
        u_n = prng.bits_to_uniform_np(n0).view(np.uint32)
        np.testing.assert_array_equal(u_j, u_t)
        np.testing.assert_array_equal(u_j, u_n)


def test_episode_uniforms_vs_jax():
    k0, k1 = jprng.lane_key(7, jnp.asarray(LANES))
    for episode in (0, 3, 2**32 - 1):
        want = np.asarray(jprng.episode_uniforms(k0, k1, jnp.uint32(episode),
                                                 9))
        got = prng.episode_uniforms(torch.from_numpy(np.asarray(k0).astype(np.int64)),
                                    torch.from_numpy(np.asarray(k1).astype(np.int64)),
                                    episode, 9).numpy()
        assert got.shape == (len(LANES), 18)
        np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_u32_bit_patterns_round_trip():
    v = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    bits = prng.from_u32(v)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy().view(np.uint32),
                                  v.numpy().astype(np.uint32))
    assert torch.equal(prng.to_u32(bits), v)


def test_action_stream_matches_test_helper():
    np.testing.assert_array_equal(prng.action_stream_np(5, 7, seed=12),
                                  action_stream(5, n=7, seed=12))
