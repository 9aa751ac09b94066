"""A configuration, a traffic mix and a per-layer metric added as new files
(and entries in BENCHMARK.json) are found by name: in a temporary copy of
the benchmark, with no other file edited, a run of the new cell works."""

import json
import shutil
import subprocess
import sys
import textwrap

from benchmark.harness import spec as S


def test_new_files_are_found_by_name(tmp_path):
    shutil.copy(S.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(S.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_dir = tmp_path / "benchmark"
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in bench_dir.rglob("*") if p.is_file()}

    # a configuration: hover under RK4
    conf = (bench_dir / "configs" / "mlp_hover.toml").read_text()
    (bench_dir / "configs" / "mlp_rk4.toml").write_text(
        conf.replace('integrator = "euler"', 'integrator = "rk4"'))
    (bench_dir / "counts" / "mlp_rk4.py").write_text(
        (bench_dir / "counts" / "mlp_hover.py").read_text())
    # a traffic mix of it
    wl = json.loads((bench_dir / "workloads" / "mlp_hover.eval.json")
                    .read_text())
    (bench_dir / "workloads" / "mlp_rk4.eval.json").write_text(
        json.dumps(dict(wl, config="mlp_rk4")))
    # a per-layer metric
    (bench_dir / "metrics" / "env_steps_a_call.eval.py").write_text(
        "def read(view):\n    return float(view.unit_work)\n")

    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "mlp_rk4", "source": "https://x.y/z",
                             "file": "benchmark/configs/mlp_rk4.toml",
                             "reduced": ["run.total_updates",
                                         "train.total_updates"],
                             "why": "a test configuration"})
    bench["workloads"].append({"name": "mlp_rk4.eval", "config": "mlp_rk4",
                               "traffic": "eval", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "env_steps_per_s":
            m["workloads"].append("mlp_rk4.eval")
    bench["per_layer"].append({"name": "env_steps_a_call.eval",
                               "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "env_steps_per_s",
                               "workloads": ["mlp_rk4.eval"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = textwrap.dedent("""
        import json, torch
        from benchmark import run
        from benchmark.harness import spec as S
        from benchmark.harness.view import View
        from benchmark.tests import tiny
        assert str(S.ROOT) == {root!r}, S.ROOT
        code, line = run.execute(tiny.args("mlp_rk4.eval"),
                                 torch.device("cpu"), tiny.adjust)
        assert code == 0, code
        res = json.loads(line)
        assert res["correct"] and "env_steps_per_s" in res["metrics"], res
        view = View(entry="eval", trace=None, kernels={{}}, step={{}},
                    peak_flops=1.0, peak_bytes_per_s=1.0, unit_work=7)
        assert S.reader("env_steps_a_call.eval").read(view) == 7.0
        print("ok")
    """).format(root=str(tmp_path))
    env = {**__import__("os").environ, "OMP_NUM_THREADS": "2",
           "PYTHONPATH": f"{tmp_path}:{S.ROOT}"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-3000:]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in bench_dir.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items()
               if "__pycache__" not in k.parts)
