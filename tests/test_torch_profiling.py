"""The port's span recorder (`drone_tpu_torch.utils.profiling`): the
no-op path with recording off, nesting and units, export, the reference's
section summary, the trainers' phase marks, evaluate()'s spans, the
profiler's clock, `run.profile_dir`'s spans.jsonl, and what
`Record.read_trace` reads under each span of a chrome trace.
"""

import importlib.util
import json
import types
from pathlib import Path

import pytest
import torch

from drone_tpu.utils.profiling import SectionTimers as JaxSectionTimers
from drone_tpu_torch import ppo, ppo_cuda, train
from drone_tpu_torch import env as tenv
from drone_tpu_torch.models import ActorCritic, LSTMActorCritic
from drone_tpu_torch.utils import profiling
from drone_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(horizon=8, num_envs=256, epochs=2, num_minibatches=2,
             anneal_lr=True, total_updates=10)
PHASES = ("rollout", "gae", "update", "metrics")
EVAL_PHASES = ("build", "load", "init_batch", "act", "stats")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_span_with_recording_off_is_the_shared_noop():
    assert profiling._recording is None
    a, b = profiling.span("drone.a"), profiling.span("drone.b")
    assert a is b is profiling._OFF
    with a, b:
        pass
    mark = profiling.phases(None)
    for name in (*PHASES, "end"):
        mark(name)
    assert profiling._recording is None
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.totals == {}


def test_recording_nests_spans_into_units_on_a_monotone_clock():
    with profiling.recording() as rec:
        assert profiling.span("drone.a") is not profiling._OFF
        with profiling.span("drone.a"):
            with profiling.span("drone.a.b"):
                pass
            with profiling.span("drone.a.c"):
                with profiling.span("drone.a.c.d"):
                    pass
        with profiling.span("drone.e"):
            pass
    assert profiling._recording is None
    names = [s.name for s in rec.spans]
    assert names == ["drone.a", "drone.a.b", "drone.a.c", "drone.a.c.d",
                     "drone.e"]
    by = {s.name: s for s in rec.spans}
    assert [s.parent for s in rec.spans] == [None, 0, 0, 2, None]
    assert [s.unit for s in rec.spans] == [1, 1, 1, 1, 2]
    for s in rec.spans:
        assert isinstance(s.start_ns, int) and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert by["drone.a.b"].end_ns <= by["drone.a.c"].start_ns
    assert by["drone.a"].end_ns <= by["drone.e"].start_ns
    assert all(s.device_ms is None for s in rec.spans)  # no CUDA here
    assert set(rec.totals) == set(names)


def test_recording_does_not_nest_and_closes_what_is_left_open():
    with pytest.raises(RuntimeError, match="already"):
        with profiling.recording():
            with profiling.recording():
                pass
    assert profiling._recording is None
    with profiling.recording() as rec:
        rec.open("drone.left")
        rec.open("drone.left.inner")
    assert [s.end_ns is not None for s in rec.spans] == [True, True]
    assert rec.spans[1].end_ns <= rec.spans[0].end_ns


def test_export_writes_a_line_a_span_that_round_trips(tmp_path):
    with profiling.recording() as rec:
        for _ in range(2):
            with profiling.span("drone.u"):
                with profiling.span("drone.u.v"):
                    pass
    rec.spans[1].trace = {"launches": 3, "syncs": 0, "runtime_ms": 0.25,
                          "idle_ms": None}
    path = tmp_path / "deep" / "spans.jsonl"
    rec.export(path)
    lines = path.read_text().splitlines()
    assert len(lines) == len(rec.spans) == 4
    back = [json.loads(line) for line in lines]
    assert back == [s.as_dict() for s in rec.spans]
    assert set(back[0]) == {"id", "name", "parent", "unit", "start_ns",
                            "end_ns", "device_ms"}
    assert back[1]["launches"] == 3 and back[3]["unit"] == 2


def test_recorded_summary_is_the_reference_section_summary():
    with profiling.recording() as rec:
        for name in ("drone.x", "drone.y", "drone.x"):
            with profiling.span(name):
                torch.ones(64).sum()
    ref = JaxSectionTimers()
    ref.totals = dict(rec.totals)
    assert rec.summary() == ref.summary()
    assert list(rec.summary()) == list(ref.summary())
    assert profiling.SectionTimers is profiling.Record


def _mlp_step(on_phase):
    cfg = ppo.PPOConfig(**SMALL)
    env = tenv.DroneEnv(device="cpu")
    model = ActorCritic((8,), generator=torch.Generator().manual_seed(3))
    runner = ppo.init_runner(model, env, cfg, seed=3)
    return ppo_cuda.make_train_step(env, cfg, on_phase=on_phase), runner


def _scan_step(on_phase):
    cfg = ppo.PPOConfig(**SMALL)
    env = tenv.DroneEnv(device="cpu")
    model = ActorCritic((8,), generator=torch.Generator().manual_seed(3))
    runner = ppo.init_runner(model, env, cfg, seed=3)
    return ppo.make_train_step(model, env, cfg, on_phase=on_phase), runner


@pytest.mark.parametrize("make", [_mlp_step, _scan_step],
                         ids=["megakernel", "scan"])
def test_phase_marks_call_on_phase_and_tile_the_step(make):
    seen = []
    step, runner = make(seen.append)
    runner, _ = step(runner)  # recording off: on_phase alone
    assert seen == [*PHASES, "end"]
    with profiling.recording() as rec:
        for _ in range(2):
            runner, _ = step(runner)
    assert seen == [*PHASES, "end"] * 3
    roots = [s for s in rec.spans if s.name == profiling.ROOT_STEP]
    assert len(roots) == 2 and [r.unit for r in roots] == [1, 2]
    for root in roots:
        kids = [s for s in rec.spans if s.parent == root.id]
        assert [s.name for s in kids] == [f"drone.train_step.{p}"
                                          for p in PHASES]
        assert kids[0].start_ns == root.start_ns
        assert kids[-1].end_ns == root.end_ns
        for a, b in zip(kids, kids[1:]):
            assert a.end_ns == b.start_ns
        assert sum(k.end_ns - k.start_ns for k in kids) == pytest.approx(
            root.end_ns - root.start_ns, rel=0.01)


def test_a_step_that_raised_is_closed_by_the_next():
    seen = []
    mark = profiling.phases(seen.append)
    with profiling.recording() as rec:
        mark("rollout")
        mark("gae")          # the step raises here
        for name in (*PHASES, "end"):
            mark(name)
    roots = [s for s in rec.spans if s.name == profiling.ROOT_STEP]
    assert len(roots) == 2 and roots[0].end_ns <= roots[1].start_ns
    assert all(s.end_ns is not None for s in rec.spans)
    assert seen == ["rollout", "gae", *PHASES, "end"]


@pytest.mark.parametrize("policy", ["mlp", "lstm"])
def test_evaluate_records_its_phases_under_one_root(policy):
    cfg = Config.default().with_overrides([
        "env.params.horizon=20", f"run.policy={policy}", "run.hidden=16",
        "run.lstm_hidden=16"])
    if policy == "lstm":
        model = LSTMActorCritic(16, (16,),
                                generator=torch.Generator().manual_seed(0))
    else:
        model = ActorCritic((16,), generator=torch.Generator().manual_seed(0))
    holder = types.SimpleNamespace(params=model.state_dict())
    plain = train.evaluate(cfg, holder, episodes=64, device="cpu")
    with profiling.recording() as rec:
        got = train.evaluate(cfg, holder, episodes=64, device="cpu")
    assert got == plain
    root = rec.spans[0]
    assert root.name == "drone.evaluate" and root.parent is None
    assert [s.name for s in rec.spans[1:]] == [f"drone.evaluate.{p}"
                                               for p in EVAL_PHASES]
    assert all(s.parent == root.id and s.unit == root.unit == 1
               for s in rec.spans[1:])
    for a, b in zip(rec.spans[1:], rec.spans[2:]):
        assert a.end_ns <= b.start_ns


def test_spans_are_user_annotations_on_the_profilers_clock(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profiling.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with profiling.span("drone.outer"):
                torch.ones(4096).cumsum(0)
                with profiling.span("drone.outer.inner"):
                    torch.ones(4096).sum()
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    chrome = json.loads((tmp_path / "t.json").read_text())
    base = chrome["baseTimeNanoseconds"]
    ann = {e["name"]: e for e in chrome["traceEvents"]
           if e.get("cat") == "user_annotation"}
    for s in rec.spans:
        e = ann[s.name]
        start_us = float(e["ts"]) + base / 1e3
        assert abs(start_us - s.start_ns / 1e3) < 500.0
        assert abs(float(e["dur"]) - (s.end_ns - s.start_ns) / 1e3) < 500.0


def test_profile_dir_writes_spans_beside_the_trace(tmp_path):
    cfg = Config.default().with_overrides([
        "train.num_envs=256", "train.horizon=8", "train.epochs=2",
        "train.num_minibatches=2", "run.hidden=16,16", "run.log_interval=1",
        "run.checkpoint_interval=100", "run.total_updates=6",
        "run.run_name=p", f"run.checkpoint_dir={tmp_path}",
        f"run.profile_dir={tmp_path / 'prof'}"])
    train.train(cfg, device="cpu")
    out = tmp_path / "prof" / "trace"
    assert (out / "trace.json").exists()
    spans = [json.loads(line)
             for line in (out / "spans.jsonl").read_text().splitlines()]
    roots = [s for s in spans if s["name"] == profiling.ROOT_STEP]
    assert len(roots) == 3  # updates 3 to 5
    assert len(spans) == 3 * (1 + len(PHASES))
    # a CPU trace: no launches, no device ops
    assert all(s["launches"] == 0 and s["idle_ms"] is None for s in spans)


def _x(cat, name, ts, dur, corr=None, **kw):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "args": {} if corr is None else {"correlation": corr}}
    e.update(kw)
    return e


def _chrome_record(spans, events, base=1_000_000_000_000):
    """A record of closed spans (name, parent, start us, end us) over a
    made-up chrome trace whose ts count from `base` ns."""
    rec = profiling.Record()
    for i, (name, parent, a, b) in enumerate(spans):
        s = profiling.Span(i, name, parent, 1, base + int(a * 1e3))
        s.end_ns = base + int(b * 1e3)
        rec.spans.append(s)
    rec.read_trace({"baseTimeNanoseconds": base, "traceEvents": events})
    return {s.name: s.trace for s in rec.spans}


def test_read_trace_subtracts_cuda_calls_from_host_time():
    got = _chrome_record(
        [("drone.train_step", None, 0.0, 1000.0),
         ("drone.train_step.gae", 0, 100.0, 300.0)],
        [_x("cuda_runtime", "cudaLaunchKernel", 110.0, 10.0, 1),
         # a launch blocked behind a full queue, and a driver call inside it
         _x("cuda_runtime", "cudaLaunchKernel", 400.0, 500.0, 2),
         _x("cuda_driver", "cuLaunchKernel", 410.0, 480.0, 2),
         _x("cuda_runtime", "cudaLaunchKernel", 990.0, 40.0, 3),
         _x("kernel", "k", 500.0, 400.0, 1),
         _x("kernel", "k", 900.0, 10.0, 2)])
    step, gae = got["drone.train_step"], got["drone.train_step.gae"]
    assert step["runtime_ms"] == pytest.approx((10 + 500 + 10) / 1e3)
    assert gae["runtime_ms"] == pytest.approx(10 / 1e3)
    assert step["launches"] == 2  # the third call launched nothing traced
    assert gae["launches"] == 1


def test_read_trace_counts_launches_and_syncs_inside_their_span_only():
    events = [
        _x("cuda_runtime", "cudaLaunchKernel", 50.0, 5.0, 1),     # before
        _x("cuda_runtime", "cudaMemcpyAsync", 120.0, 5.0, 2),
        _x("cuda_runtime", "cudaMemsetAsync", 130.0, 5.0, 3),
        _x("cuda_runtime", "cudaLaunchKernel", 140.0, 5.0, 4),
        _x("cuda_runtime", "cudaStreamSynchronize", 150.0, 20.0, 5),
        _x("cuda_runtime", "cudaMemcpy", 180.0, 5.0, 6),
        _x("cuda_runtime", "cudaLaunchKernel", 250.0, 5.0, 7),   # after
        _x("cuda_runtime", "cudaDeviceSynchronize", 260.0, 5.0, 8),
        _x("kernel", "k", 60.0, 10.0, 1),
        _x("gpu_memcpy", "Memcpy DtoH", 130.0, 5.0, 2),
        _x("gpu_memset", "Memset", 140.0, 5.0, 3),
        _x("kernel", "k", 150.0, 10.0, 4),
        _x("kernel", "k", 260.0, 10.0, 7)]
    got = _chrome_record([("drone.train_step.gae", None, 100.0, 200.0)],
                         events)["drone.train_step.gae"]
    assert got["launches"] == 3 and got["syncs"] == 2


def test_read_trace_reads_device_idle_under_each_span():
    events = [_x("kernel", "act", 100.0, 600.0, 1),
              _x("kernel", "act", 650.0, 100.0, 2),   # overlaps the first
              _x("gpu_memcpy", "Memcpy DtoH", 780.0, 10.0, 3)]
    got = _chrome_record(
        [("drone.evaluate", None, 0.0, 1000.0),
         ("drone.evaluate.build", 0, 0.0, 50.0),
         ("drone.evaluate.init_batch", 0, 50.0, 120.0),
         ("drone.evaluate.act", 0, 120.0, 200.0),
         ("drone.evaluate.stats", 0, 200.0, 1000.0)], events)
    assert got["drone.evaluate.build"]["idle_ms"] == pytest.approx(0.05)
    assert got["drone.evaluate.init_batch"]["idle_ms"] == pytest.approx(0.05)
    assert got["drone.evaluate.act"]["idle_ms"] == pytest.approx(0.0)
    # busy 200-750 and 780-790 inside the stats span
    assert got["drone.evaluate.stats"]["idle_ms"] == pytest.approx(
        (800 - 560) / 1e3)
    assert got["drone.evaluate"]["idle_ms"] == pytest.approx(
        (1000 - 660) / 1e3)
    # no device op in the trace: no idle time to read
    cpu = _chrome_record([("drone.evaluate", None, 0.0, 10.0)], [])
    assert cpu["drone.evaluate"]["idle_ms"] is None


@pytest.mark.parametrize("entry", ["train", "eval"])
def test_span_pass_rehearses_on_the_cpu(entry, capsys):
    spec = importlib.util.spec_from_file_location(
        "span_pass", ROOT / "scripts" / "span_pass.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main([
        str(ROOT / "configs" / "hover.toml"), entry, "--device", "cpu",
        "--seconds", "0", "--episodes", "32", "train.num_envs=256",
        "train.horizon=8", "train.epochs=1", "train.num_minibatches=2",
        "run.hidden=16,16", "env.params.horizon=20"]) == 0
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert res["card"] == "cpu" and res["units_on"] >= 3
    assert len(res["unit_ms_off"]) == len(res["unit_ms_on"]) == 2
    assert res["idle_share"] is None  # no device in a CPU trace
    if entry == "train":
        assert res["updates"] == res["units_on"]
        assert res["phase_cover"] == pytest.approx(100.0)
        assert res["gae_launches"] == 0 and res["host_syncs"] == 0
        assert res["host_busy_ms"] == pytest.approx(res["host_ms"])
        assert res["synced"]["updates"] >= 3 and res["synced"]["host_ms"] > 0
    else:
        assert res["calls"] == res["units_on"]
        assert res["eval_setup_ms"] == pytest.approx(
            sum(res[p]["host_ms"] for p in ("build", "load", "init_batch")))
        assert "setup_idle_share" not in res
