"""The control of `correct`: the plain reference put in the program's
place with its products in TF32 (operands rounded to 10 mantissa bits, the
step below the configurations' float32) fails at least one of the cell's
numbers against its limit, while the reference against itself passes them
all. Small sizes on the CPU; at the cells' own sizes on the card
(`card`), as `python -m benchmark.calibrate` reads it there."""

import pytest
import torch

from benchmark.entries import eval as eval_entry
from benchmark.entries import train as train_entry
from benchmark.harness import weights
from benchmark.reference import nets
from benchmark.tests.test_bench_reference import _ctx


def _fails(checks, limits):
    return [k for k, v in limits.items() if checks[k] > v]


@pytest.mark.parametrize("cell", ["mlp_hover.train", "lstm_hover.train"])
def test_training_control_fails(cell):
    ctx = _ctx(cell)
    sd = weights.make(nets.param_shapes(ctx.tables["run"]), ctx.seed, "cpu")
    ref = train_entry.reference(ctx, sd)
    limits = ctx.workload["limits"]
    assert not _fails(train_entry.gaps(sd, ref, ref), limits)
    control = train_entry.reference(ctx, sd, "tf32")
    assert _fails(train_entry.gaps(sd, control, ref), limits)


@pytest.mark.parametrize("cell", ["mlp_hover.eval", "lstm_hover.eval"])
def test_evaluation_control_fails(cell):
    ctx = _ctx(cell)
    ctx.tables["run"].update(hidden=[64, 64], lstm_hidden=64)
    ctx.tables["env"].pop("horizon")  # 1,001 steps, as the cells run
    ctx.workload = dict(ctx.workload, episodes=2048)
    sd = weights.make(nets.param_shapes(ctx.tables["run"]), ctx.seed, "cpu")
    ref = eval_entry.reference(ctx, sd, 1)
    assert not _fails(eval_entry.gaps(_as_program(ref), ref),
                      ctx.workload["limits"])
    control = _as_program(eval_entry.reference(ctx, sd, 1, "tf32"))
    assert _fails(eval_entry.gaps(control, ref), ctx.workload["limits"])


def _as_program(ref):
    """A reference evaluation's output where the program's is read."""
    from benchmark.calibrate import _lane_rows, _State

    stats, acc, final = ref
    return stats, (_State(final), _lane_rows(acc))


@pytest.mark.card
@pytest.mark.parametrize("cell", ["mlp_hover.train", "mlp_hover.eval"])
def test_control_fails_at_the_cells_size(card, cell):
    from benchmark.calibrate import context, eval_readings, train_readings

    ctx = context(cell, 5_000_000_003, card)
    read = train_readings if cell.endswith("train") else eval_readings
    readings = dict(read(ctx, control=True, faults=False))
    limits = ctx.workload["limits"]
    assert not _fails(readings["program"], limits)
    assert _fails(readings["control_tf32"], limits)
    torch.cuda.empty_cache()
