"""The plain reference against the program's plain versions, at small sizes
on the CPU: the env bitwise; a training run's first updates and an
evaluation's statistics to float32 rounding. (The test imports both; the
reference imports nothing of the program.)"""

import pytest
import torch

from benchmark.entries import eval as eval_entry
from benchmark.entries import train as train_entry
from benchmark.harness import spec as S
from benchmark.reference import env as R
from benchmark.tests import tiny


@pytest.mark.parametrize("integrator", ["euler", "rk4"])
def test_env_bitwise(integrator):
    from drone_tpu_torch import env as E
    from drone_tpu_torch.env import DroneEnv
    from drone_tpu_torch.ops.cuda_acting import gauss4

    n, seed = 256, 4_000_000_007
    de = DroneEnv(integrator=integrator, device="cpu")
    s = de.init_batch(seed, n)
    p = R.params({"task": "hover", "integrator": integrator}, "cpu")
    r = R.init(seed, n, p, "cpu")
    gen = torch.Generator().manual_seed(1)
    for _ in range(150):
        assert torch.equal(E.observe(s), R.observe(r))
        assert torch.equal(gauss4(s), R.gauss4(r))
        a = torch.randn(n, 4, generator=gen) * 1.5
        s, out = E.step(s, a, de.params, de.statics)
        r, rew, done, ret, ln = R.step(r, a, p)
        assert torch.equal(out.reward, rew)
        assert torch.equal(out.terminated | out.truncated, done)
        assert torch.equal(out.ep_return, ret)
        assert torch.equal(out.ep_length.long(), ln)
    assert int(r["episode"].sum()) > n  # resets happened


def _ctx(cell, seed=3_000_000_019):
    bench = S.load_spec()
    c = S.cell(bench, cell)
    tables = S.config_tables(S.ROOT / S.config_entry(bench, c["config"])["file"])
    tables, wl = tiny.adjust(tables, S.workload_file(cell))
    from types import SimpleNamespace

    return SimpleNamespace(name=cell, workload=wl, tables=tables, seed=seed,
                           seconds=0.0, trace=False,
                           device=torch.device("cpu"), t0=0.0, kernels={},
                           step={}, peak_flops=1.0, peak_bytes_per_s=1.0,
                           log=lambda m: None)


@pytest.mark.parametrize("cell", ["mlp_hover.train", "lstm_hover.train"])
def test_training_follows_the_program(cell):
    ctx = _ctx(cell)
    st = train_entry.start(ctx)
    sd, prog = st["sd"], st["prog"]
    gaps = train_entry.gaps(sd, prog, train_entry.reference(ctx, sd))
    assert gaps["lanes_apart"] == 0.0
    for k in ("loss_gap", "rollout_gap", "grad_gap"):
        assert gaps[k] < 1e-5, gaps
    assert gaps["change_gap"] < 1e-4, gaps


@pytest.mark.parametrize("cell", ["mlp_hover.eval", "lstm_hover.eval"])
def test_evaluation_follows_the_program(cell):
    from types import SimpleNamespace

    from drone_tpu_torch import train as T

    from benchmark.harness import program, weights
    from benchmark.reference import nets

    ctx = _ctx(cell)
    cfg = program.config(ctx.tables, ctx.seed + 1)
    sd = weights.make(nets.param_shapes(ctx.tables["run"]), ctx.seed, "cpu")
    answer = T.evaluate(cfg, SimpleNamespace(params=sd), episodes=256,
                        deterministic=True, device="cpu")
    ref, acc, _ = eval_entry.reference(ctx, sd, 1)
    assert answer["episodes"] == ref["episodes"] > 0
    assert eval_entry.stats_gap(answer, ref) < 1e-6
