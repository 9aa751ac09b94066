"""drone_tpu_torch.models.mlp against drone_tpu.models.mlp.

The converters carry flax weights into the torch module and back bitwise;
the same weights give the same forward pass to float32 matmul tolerance
(rtol 1e-5 / atol 1e-6: the two backends sum the products in different
orders, and tanh differs by a few ulp).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from drone_tpu.models import ActorCritic as FlaxActorCritic
from drone_tpu_torch.models import ActorCritic, params_from_flax, params_to_flax

HIDDENS = [(64, 64), (32, 32, 32), (16,)]


def _flax(hidden, seed=0):
    model = FlaxActorCritic(hidden=hidden)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 13)))
    return model, jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("hidden", HIDDENS)
def test_converter_round_trip_is_bitwise(hidden):
    _, params = _flax(hidden)
    module = ActorCritic(hidden)
    module.load_state_dict(params_from_flax(params))
    back = params_to_flax(module)
    want = jax.tree_util.tree_leaves_with_path(params)
    got = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in want] == [p for p, _ in got]
    for (path, a), (_, b) in zip(want, got):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("hidden", HIDDENS)
def test_forward_matches_flax_apply(hidden):
    fmodel, params = _flax(hidden, seed=1)
    module = ActorCritic(hidden)
    module.load_state_dict(params_from_flax(params))
    obs = np.random.default_rng(0).normal(size=(512, 13)).astype(np.float32)
    f_mean, f_log_std, f_value = fmodel.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        mean, log_std, value = module(torch.from_numpy(obs))
    np.testing.assert_allclose(mean.numpy(), np.asarray(f_mean),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(value.numpy(), np.asarray(f_value),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(log_std.detach().numpy(),
                                  np.asarray(f_log_std))
    assert value.shape == (512,) and mean.shape == (512, 4)


def test_init_distributions_match_flax():
    """lecun-normal hidden layers, orthogonal(0.01) mean head, orthogonal(1)
    value head, zero biases, log_std 0; a seeded generator reproduces."""
    g = torch.Generator().manual_seed(5)
    m = ActorCritic((256, 256), generator=g)
    w = m.actor_h1.weight.detach()
    assert abs(float(w.std()) - (1 / 256) ** 0.5) < 0.05 * (1 / 256) ** 0.5
    assert float(w.abs().max()) <= 2 * (1 / 256) ** 0.5 / 0.87962566 + 1e-6
    for head, gain in ((m.actor_mean, 0.01), (m.critic_value, 1.0)):
        wh = head.weight.detach()
        torch.testing.assert_close(wh @ wh.t(),
                                   gain**2 * torch.eye(wh.shape[0]),
                                   rtol=1e-4, atol=1e-6)
    for name, t in m.state_dict().items():
        if name.endswith("bias") or name == "log_std":
            assert not t.any(), name
    m2 = ActorCritic((256, 256), generator=torch.Generator().manual_seed(5))
    for (name, a), b in zip(m.state_dict().items(), m2.state_dict().values()):
        assert torch.equal(a, b), name
    _, fparams = _flax((256, 256))
    assert sorted(params_from_flax(fparams)) == sorted(m.state_dict())


def test_bfloat16_compute_is_close_to_float32():
    m = ActorCritic((64, 64), generator=torch.Generator().manual_seed(0))
    mb = ActorCritic((64, 64), dtype=torch.bfloat16)
    mb.load_state_dict(m.state_dict())
    obs = torch.randn(64, 13, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, _, v = m(obs)
        ab, _, vb = mb(obs)
    assert ab.dtype == torch.float32 and vb.dtype == torch.float32
    torch.testing.assert_close(ab, a, rtol=0.05, atol=0.01)
