"""`cli bench`: drone_tpu_torch.bench and drone_tpu_torch.utils.profiling.

The bench's phases run on the card; here each runs through its kernels'
plain versions at a tiny shape on the CPU. The JSON it prints is held to
the reference's keys (the root bench.py, read as source: it imports JAX
and drives the TPU), and the profiling helpers to drone_tpu's.
"""

import ast
import json
from pathlib import Path

import pytest
import torch

from drone_tpu.utils.profiling import SectionTimers as JaxSectionTimers
from drone_tpu_torch import bench, cli
from drone_tpu_torch.env import DroneEnv
from drone_tpu_torch.ops import rollout_cuda
from drone_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
HOVER = ROOT / "configs" / "hover.toml"
TINY = dict(N=64, T=4, iters=1)
# the megakernel trainers take lanes in rows of 128 a minibatch: their 4
# minibatches need 512; the scan trainers take any lanes that split in 4
TINY_TRAIN = dict(N=512, T=4, iters=1)
TINY_SCAN = dict(N=32, T=2, iters=1)


@pytest.fixture(autouse=True)
def one_repeat(monkeypatch):
    """Each phase timed once: the CPU runs its plain versions."""
    monkeypatch.setattr(bench, "REPEATS", 1)


@pytest.fixture(autouse=True)
def one_thread():
    """torch on one thread: in the parallel test run the workers share the
    cores, and torch's intra-op threads spin against each other there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_keys():
    """(the headline's keys, the secondary phases' keys in order) of the
    root bench.py's main."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    phases = [n.elts[0].value for n in ast.walk(main)
              if isinstance(n, ast.Tuple) and len(n.elts) == 2
              and isinstance(n.elts[0], ast.Constant)
              and isinstance(n.elts[1], ast.Lambda)]
    dicts = [n for n in ast.walk(main) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == "metric"
                     for k in n.keys)]
    return [k.value for k in dicts[0].keys], phases


@pytest.mark.parametrize("phase,kwargs", [
    (bench.bench_megakernel, TINY),
    (bench.bench_acting_megakernel, TINY),
    (bench.bench_policy_rollout, TINY),
    (bench.bench_traj_rollout, TINY),
    (bench.bench_lstm_acting, TINY),
    (bench.bench_cnn_acting, TINY),
    (bench.bench_cnn_lstm_acting, TINY),
    (bench.bench_train, TINY_TRAIN),
    (bench.bench_train_rnn, dict(TINY_TRAIN, bptt=2)),
    (bench.bench_train_rnn, dict(TINY_TRAIN, bptt=2, policy="cnn_lstm")),
    (bench.bench_train_cnn, TINY_TRAIN),
    (bench.bench_train_scan, TINY_SCAN),
    (bench.bench_train_rnn_scan, dict(TINY_SCAN, bptt=2)),
    (bench.bench_train_cnn_scan, TINY_SCAN),
    (bench.bench_train_cnn_overlap_scan, dict(TINY_SCAN, grad_accum=2)),
], ids=lambda v: getattr(v, "__name__", None) or v.get("policy", "kwargs"))
def test_phase_on_cpu_gives_positive_rates(phase, kwargs):
    launches = rollout_cuda.launches
    rates = phase(DroneEnv(device="cpu"), **kwargs)
    assert len(rates) == bench.REPEATS == 1
    assert all(r > 0 and r != float("inf") for r in rates)
    assert rollout_cuda.launches == launches  # CPU tensors: no kernel


def test_json_has_the_reference_keys_and_device():
    headline, secondary = _reference_keys()
    env = DroneEnv(device="cpu")
    phases = bench.phases(env)
    assert [k for k, _ in phases] == secondary
    assert all(callable(fn) for _, fn in phases)
    rates = {k: [3.0, 1.0, 2.0] for k, _ in phases}
    out = json.loads(json.dumps(bench.result("hover", "cpu", 8e6, 0.25,
                                             rates)))
    assert list(out) == [*headline, "device"]
    assert list(out["secondary"]) == secondary
    assert list(out["spread"]) == ["headline", *secondary]
    for key in secondary:
        assert out["secondary"][key] == 2.0
        assert out["spread"][key] == 1.0
    assert out["metric"] == "env_steps_per_s_batched_hover_1chip"
    assert out["vs_baseline"] == round(8e6 / 6.25e6, 3)
    assert out["repeats"] == bench.REPEATS and out["device"] == "cpu"


def test_other_tasks_run_the_reference_phases():
    env = DroneEnv("waypoint", "rk4", device="cpu")
    assert [k for k, _ in bench.phases(env)] == _reference_keys()[1][:2]


def test_section_timers_summary_matches_reference():
    totals = {"rollout": 1.25, "update": 3.5, "gae": 0.0625, "log": 0.0}
    ours, ref = profiling.SectionTimers(), JaxSectionTimers()
    ours.totals, ref.totals = dict(totals), dict(totals)
    assert ours.summary() == ref.summary()
    assert list(ours.summary()) == list(ref.summary())
    with ours.section("update"):
        pass
    assert ours.totals["update"] > 3.5


def test_trace_on_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_cli_bench_without_a_card_fails_naming_the_cpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ran = []
    monkeypatch.setattr(bench, "bench_megakernel",
                        lambda *a, **k: ran.append(a) or [1.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["bench", str(HOVER)])
    assert not ran


def test_cli_bench_on_cpu_prints_one_json_line(monkeypatch, capsys):
    """`cli bench --device cpu` runs every phase and prints the JSON line:
    here with each phase at a tiny shape."""
    for name in ("bench_megakernel", "bench_acting_megakernel",
                 "bench_policy_rollout", "bench_traj_rollout",
                 "bench_lstm_acting", "bench_cnn_acting",
                 "bench_cnn_lstm_acting"):
        fn = getattr(bench, name)
        monkeypatch.setattr(bench, name,
                            lambda env, fn=fn: fn(env, N=64, T=2, iters=1))
    for name in ("bench_train", "bench_train_rnn", "bench_train_cnn",
                 "bench_train_scan", "bench_train_rnn_scan",
                 "bench_train_cnn_scan", "bench_train_cnn_overlap_scan"):
        monkeypatch.setattr(bench, name, lambda env, **k: [1.0])
    assert cli.main(["bench", str(HOVER), "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert len(lines) == 1 and out["device"] == "cpu"
    assert out["value"] > 0 and out["repeats"] == bench.REPEATS
    assert all(v > 0 for v in out["secondary"].values())
