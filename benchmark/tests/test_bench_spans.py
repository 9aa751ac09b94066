"""The program's span pass (`scripts/span_pass.py`) on the card, at each
cell's configuration: every one of the span metrics comes out of a train
and an evaluate() run, and holds the relations the spans promise. It is
not a cell: the benchmark's runs record no spans."""

import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
TRAIN = ("host_busy_ms", "gae_launches", "host_syncs")
EVAL = ("eval_setup_ms", "setup_idle_share", "init_batch_launches")


def _span_pass():
    spec = importlib.util.spec_from_file_location(
        "span_pass", ROOT / "scripts" / "span_pass.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.card
@pytest.mark.parametrize("config", ["mlp_hover", "lstm_hover"])
@pytest.mark.parametrize("entry", ["train", "eval"])
def test_span_pass_yields_every_span_metric(card, config, entry, capsys):
    code = _span_pass().main([
        str(ROOT / "benchmark" / "configs" / f"{config}.toml"), entry,
        "--seed", "4000000007", "--seconds", "0.5"])
    assert code == 0
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert res["card"] != "cpu"
    for name in TRAIN if entry == "train" else EVAL:
        assert res[name] is not None and res[name] >= 0, name
    if entry == "train":
        assert res["host_syncs"] == 0
        assert res["gae_launches"] > 0
        assert 0 < res["host_busy_ms"] < res["host_ms"]
        assert res["phase_cover"] >= 95.0
        assert res["gae"]["device_ms"] > 0 and res["update"]["device_ms"] > 0
    else:
        assert res["init_batch_launches"] > 0
        assert 0 < res["setup_idle_share"] <= res["idle_share"]
        assert res["eval_setup_ms"] < res["host_ms"]
