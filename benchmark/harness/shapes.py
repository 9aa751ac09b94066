"""Products and bytes of the MLP and LSTM policies' kernels and steps,
worked out from the shapes of a configuration (model FLOPs: 2 a
multiply-add of a product the algorithm needs, no recompute, no work an
implementation adds; the env's elementwise work and the activations are
not counted, so every share built on these is a lower bound). Bytes: each
input read once and each output written once, float32 (4 bytes a word).
"""

from __future__ import annotations

OBS, ACT = 13, 4
STATE_WORDS = 25   # an env lane's state: 19 float, 4 uint32, 2 int32 words
STATS_WORDS = 5    # a lane's episode statistics
PLANE_WORDS = 21   # a sample's trajectory plane: obs, action, logp, value,
                   # reward, done
SAMPLE_WORDS = 21  # what an update reads of a sample: obs, action, logp,
                   # value, advantage, return


def _tower(widths, n_out):
    """[(in, out)] of a tanh tower over the observation."""
    dims, fan = [], OBS
    for w in widths:
        dims.append((fan, w))
        fan = w
    return dims + [(fan, n_out)]


def mlp_counts(hidden, num_envs, horizon, epochs, minibatches,
               eval_lanes, eval_steps) -> tuple[dict, dict]:
    """({kernel: {"flops", "bytes"} a call}, {"train": FLOPs a sample,
    "eval": FLOPs an env step}) of the MLP actor-critic."""
    actor, critic = _tower(hidden, ACT), _tower(hidden, 1)
    macs_a = sum(i * o for i, o in actor)
    macs_c = sum(i * o for i, o in critic)
    params = sum((i + 1) * o for i, o in actor + critic) + ACT
    fwd = 2 * (macs_a + macs_c)
    # backward: every weight gradient, and the input gradient of every layer
    # but the first (the observation needs none)
    dx = 2 * sum(i * o for i, o in actor[1:] + critic[1:])
    update = fwd + fwd + dx
    n, T = num_envs, horizon
    mb = n * T // minibatches
    kernels = {
        "K2": {"flops": n * T * fwd,
               "bytes": 4 * (params + n * (2 * STATE_WORDS + STATS_WORDS)
                             + T * n * PLANE_WORDS)},
        "K3": {"flops": mb * update,
               "bytes": 4 * (mb * SAMPLE_WORDS + 2 * params + 8)},
        "K4": {"flops": 0, "bytes": 4 * 7 * params},
        "K5": {"flops": eval_lanes * eval_steps * 2 * macs_a,
               "bytes": 4 * (params + eval_lanes
                             * (2 * STATE_WORDS + STATS_WORDS))},
    }
    step = {"train": fwd + epochs * update + 2 * macs_c / T,
            "eval": 2 * macs_a}
    return kernels, step


def lstm_counts(hidden, encoder, num_envs, horizon, bptt, epochs,
                minibatches, eval_lanes, eval_steps) -> tuple[dict, dict]:
    """The same for the LSTM actor-critic (a tanh encoder, one LSTM cell
    of `hidden` units, action and value heads on h')."""
    H = int(hidden)
    enc = _tower(encoder, 0)[:-1]
    E = enc[-1][1] if enc else OBS
    cell = sum(i * o for i, o in enc) + 4 * H * (E + H)
    params = (sum((i + 1) * o for i, o in enc) + 4 * H * E + 4 * H * H
              + 4 * H + (H + 1) * (ACT + 1) + ACT)
    fwd = 2 * (cell + H * (ACT + 1))
    # backward: every weight gradient; the input gradients of the heads,
    # of the gates ([x; h]) and of every encoder layer but the first
    dx = 2 * (H * (ACT + 1) + 4 * H * (E + H) + sum(i * o for i, o in enc[1:]))
    update = fwd + fwd + dx
    n, T = num_envs, horizon
    carry = 2 * H
    mb_lanes = n // minibatches
    mb = mb_lanes * T
    kernels = {
        "K6": {"flops": n * T * fwd,
               "bytes": 4 * (params + n * (2 * STATE_WORDS + STATS_WORDS
                                           + 2 * carry)
                             + T * n * PLANE_WORDS + (T // bptt) * carry * n)},
        "K7": {"flops": mb * update,
               "bytes": 4 * (mb * SAMPLE_WORDS + (T // bptt) * carry * mb_lanes
                             + 2 * params + 8)},
        "K4": {"flops": 0, "bytes": 4 * 7 * params},
        "K8": {"flops": eval_lanes * eval_steps * 2 * (cell + H * ACT),
               "bytes": 4 * (params + eval_lanes
                             * (2 * STATE_WORDS + STATS_WORDS + 2 * carry))},
    }
    step = {"train": fwd + epochs * update + 2 * (cell + H) / T,
            "eval": 2 * (cell + H * ACT)}
    return kernels, step
