"""A run (small, on the CPU, the chip's look skipped) with the timed path
broken underneath comes out not correct, once for each fault the cell can
have: a step that returns its state unchanged, half of the batch left out
and the mean taken over the rest, an answer altered where it is
produced. (The cells run on one chip: no exchange between chips to leave
out.) A sound run comes out correct."""

import dataclasses
import json

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny


def _run(cell):
    code, line = run.execute(tiny.args(cell), torch.device("cpu"),
                             tiny.adjust)
    assert code == 0 and line
    return json.loads(line)


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"


def _unchanged_step(monkeypatch):
    """Every step restores the runner's parameters, optimizer state, env
    lanes and carry after it ran: the state comes back unchanged."""
    from drone_tpu_torch import train as T

    real_make = T.make_sharded_train_step

    def make(*args, **kwargs):
        real = real_make(*args, **kwargs)

        def step(runner):
            keep = [t.clone() for t in (runner.params.flat,
                                        *runner.opt_state)]
            env = dataclasses.replace(runner.env_state)
            carry = tuple(c.clone() for c in getattr(runner, "carry", ()))
            out, m = real(runner)
            for dst, src in zip((runner.params.flat, *runner.opt_state),
                                keep):
                dst.copy_(src)
            return dataclasses.replace(out, env_state=env, **(
                {"carry": carry} if carry else {})), m

        step.kind, step.mesh = "megakernel", None
        return step

    monkeypatch.setattr(T, "make_sharded_train_step", make)


def _half_batch(monkeypatch, cell):
    """The update kernel sees the first half of each minibatch's row blocks
    and takes its mean over them."""
    from drone_tpu_torch import ppo_cuda, ppo_rnn_cuda

    if cell.startswith("lstm"):
        real = ppo_rnn_cuda.lstm_update_cuda

        def half(planes, advret, snap, perm_mb, theta, arch, co, *a, **k):
            co2 = dataclasses.replace(co, inv_m=2 * co.inv_m)
            return real(planes, advret, snap, perm_mb[:len(perm_mb) // 2],
                        theta, arch, co2, *a, **k)

        monkeypatch.setattr(ppo_rnn_cuda, "lstm_update_cuda", half)
    else:
        real = ppo_cuda.ppo_update_cuda

        def half(planes, advret, perm_mb, theta, hidden, co, *a, **k):
            co2 = dataclasses.replace(co, inv_m=2 * co.inv_m)
            return real(planes, advret, perm_mb[:len(perm_mb) // 2], theta,
                        hidden, co2, *a, **k)

        monkeypatch.setattr(ppo_cuda, "ppo_update_cuda", half)


def _half_lanes(monkeypatch, cell):
    """The acting kernel rolls out the first half of the lanes only."""
    from drone_tpu_torch import train as T
    from drone_tpu_torch.types import EnvState

    def cut(state):
        n = state.n // 2
        return EnvState(**{f.name: getattr(state, f.name)[:n]
                           for f in dataclasses.fields(state)})

    if cell.startswith("lstm"):
        real = T.lstm_act_rollout_cuda

        def half(state, theta, arch, carry, *a, **k):
            n = state.n // 2
            return real(cut(state), theta, arch, tuple(c[:n] for c in carry),
                        *a, **k)

        monkeypatch.setattr(T, "lstm_act_rollout_cuda", half)
    else:
        real = T.act_rollout_cuda
        monkeypatch.setattr(T, "act_rollout_cuda",
                            lambda state, *a, **k: real(cut(state), *a, **k))


def _altered_answer(monkeypatch):
    """The statistics come back with one more episode's return in their
    sum."""
    from drone_tpu_torch import train as T

    real = T._episode_stats

    def altered(stats):
        stats = dict(stats)
        stats["ep_return_sum"] = (stats["ep_return_sum"]
                                  * (1.0 + 1.0 / float(stats["episodes"])))
        return real(stats)

    monkeypatch.setattr(T, "_episode_stats", altered)


@pytest.mark.parametrize("cell,fault", [
    ("mlp_hover.train", "unchanged"), ("mlp_hover.train", "half_batch"),
    ("lstm_hover.train", "unchanged"), ("lstm_hover.train", "half_batch"),
    ("mlp_hover.eval", "half_lanes"), ("mlp_hover.eval", "altered"),
    ("lstm_hover.eval", "half_lanes"), ("lstm_hover.eval", "altered"),
])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    if fault == "unchanged":
        _unchanged_step(monkeypatch)
    elif fault == "half_batch":
        _half_batch(monkeypatch, cell)
    elif fault == "half_lanes":
        _half_lanes(monkeypatch, cell)
    else:
        _altered_answer(monkeypatch)
    res = _run(cell)
    assert res["correct"] is False, res["checks"]
