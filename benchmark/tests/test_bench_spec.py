"""BENCHMARK.json against the benchmark's contract: names, units, keys,
lengths, the cells' metrics, and the files each entry names."""

import json
import re

import pytest

from benchmark.harness import spec as S

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return S.load_spec()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes(bench):
    assert set(bench) == KEYS["top"]
    assert len((S.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            extra = set(entry) - KEYS[section]
            assert extra <= ({"workloads"} if section in
                             ("end_to_end", "per_layer") else set()), entry
            assert KEYS[section] <= set(entry), entry
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for k in ("why", "layer", "source"):
            if k in e:
                assert _line(e[k]), (e["name"], k)
    if section == "workloads":
        for e in bench[section]:
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
    if section == "configs":
        for e in bench[section]:
            assert len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])


def test_command_and_paths(bench):
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (S.ROOT / p).is_dir()
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_reports_enough(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    names = {w["name"] for w in bench["workloads"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", names)) <= names
    for w in names:
        ends = [m for m in bench["end_to_end"] if S.reports(m, w, bench)]
        assert "setup_s" in [m["name"] for m in ends]
        assert len(ends) >= 2
        layers = [m for m in bench["per_layer"] if S.reports(m, w, bench)]
        assert layers, w
        for m in layers:  # a per-layer metric's cell reports what it moves
            assert S.reports(e2e[m["moves"]], w, bench), (m["name"], w)


def test_layers_one_name_each(bench):
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"entry point", "trainers", "whole training step",
                           "whole evaluate call", "kernels", "device"}
    for m in bench["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_name_has_its_files(bench):
    for c in bench["configs"]:
        assert (S.ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        tables = S.config_tables(S.ROOT / c["file"])
        assert tables["benchmark"]["reduced"] == c["reduced"]
        assert (S.BENCH / "counts" / f"{c['name']}.py").is_file()
    for w in bench["workloads"]:
        wl = S.workload_file(w["name"])
        assert wl["config"] == w["config"]
        assert S.entry(wl["entry"]).run
    for m in bench["per_layer"]:
        assert callable(S.reader(m["name"]).read)


def test_workload_files_name_only_known_keys():
    for path in (S.BENCH / "workloads").glob("*.json"):
        wl = json.loads(path.read_text())
        assert set(wl) <= {"config", "entry", "sources", "checked_updates",
                           "checked_within", "episodes", "trace_seconds",
                           "limits"}, path
        assert wl["limits"] and all(v > 0 for v in wl["limits"].values())
