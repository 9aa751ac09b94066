"""The reduction of a trace to the per-layer metrics, on a made-up chrome
trace: the window, the device's busy time and idle gaps, each kernel's
time a call, the roofline and mfu arithmetic, and the percentile."""

import pytest

from benchmark.harness import program, trace
from benchmark.harness.view import View


def _ev(name, cat, ts, dur):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur}


def _events():
    return [
        _ev(trace.WINDOW, "user_annotation", 100.0, 1000.0),
        _ev("aten::add", "cpu_op", 100.0, 50.0),      # host, device idle
        _ev("void drone::traj_kernel<0>(int)", "kernel", 90.0, 60.0),
        _ev("void drone::pack_traj_kernel(int)", "kernel", 200.0, 100.0),
        _ev("void drone::traj_kernel<0>(int)", "kernel", 250.0, 250.0),
        _ev("Memcpy HtoD", "gpu_memcpy", 600.0, 100.0),
        _ev("aten::item", "cpu_op", 700.0, 400.0),
        _ev("void drone::adam_kernel(int)", "kernel", 1000.0, 200.0),
    ]


def test_parse_window_busy_and_gaps():
    tr = trace.parse(_events())
    assert tr.window_s == pytest.approx(1000e-6)
    # [100,150] from the clipped kernel, [200,500], [600,700], [1000,1100]
    assert tr.busy_s == pytest.approx((50 + 300 + 100 + 100) * 1e-6)
    assert tr.total("drone::traj_kernel") == (pytest.approx(300e-6), 2)
    assert tr.total("drone::pack_traj_kernel")[1] == 1
    assert tr.total("drone::adam_kernel")[0] == pytest.approx(100e-6)
    # gaps: [150,200] (no host op), [500,600] (no host op), [700,1000] item
    assert tr.gaps["aten::item"] == pytest.approx(300e-6)
    assert sum(tr.gaps.values()) == pytest.approx(450e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].startswith("void drone::traj_kernel")
    assert bd["idle_gaps"][0] == ["aten::item", pytest.approx(300e-6)]


def test_parse_needs_device_activity():
    with pytest.raises(RuntimeError):
        trace.parse([_ev(trace.WINDOW, "user_annotation", 0.0, 10.0)])


def test_view_roofline_mfu_idle():
    tr = trace.parse(_events())
    tr.units = 2
    view = View(entry="train", trace=tr,
                kernels={"K2": {"flops": 3e9, "bytes": 1e6}},
                step={"train": 1e3}, peak_flops=1e14, peak_bytes_per_s=1e12,
                unit_work=10)
    # K2 a call: (300 + 100) us over 2 launches of the anchor
    assert view.call_seconds("drone::traj_kernel",
                             own=("drone::pack_traj_kernel",)) == \
        pytest.approx(200e-6)
    # least time max(3e9/1e14, 1e6/1e12) = 30 us: 15% of 200 us
    assert view.roofline("K2", "drone::traj_kernel",
                         own=("drone::pack_traj_kernel",)) == \
        pytest.approx(15.0)
    assert view.roofline("K3", "drone::update_kernel") is None
    assert view.mfu() == pytest.approx(100 * 2e4 / 1e-3 / 1e14)
    assert view.idle_share() == pytest.approx(45.0)
    assert view.phase_ms("gae") is None


def test_shared_kernel_takes_its_mean_launch():
    tr = trace.parse(_events())
    view = View(entry="train", trace=tr, kernels={}, step={},
                peak_flops=1.0, peak_bytes_per_s=1.0, unit_work=1)
    assert view.call_seconds("drone::adam_kernel",
                             shared=("drone::traj_kernel",)) == \
        pytest.approx(100e-6 + 150e-6)


def test_percentile_nearest_rank():
    vals = list(range(1, 201))
    assert program.percentile(vals, 95) == 190
    assert program.percentile(vals, 50) == 100
    assert program.percentile([5.0], 95) == 5.0
