"""What the benchmark loads: no JAX, no JAX package and no oracle in a run
(top-level module names compared whole), and a reference that imports
nothing of the program."""

import ast
import subprocess
import sys
import textwrap

import pytest

from benchmark import run
from benchmark.harness import spec as S

FORBIDDEN = {"jax", "jaxlib", "flax", "drone_tpu", "oracle"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(S.BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(S.BENCH)))
def test_sources_import_no_jax(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & FORBIDDEN, path


@pytest.mark.parametrize("path", sorted((S.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert tops <= {"__future__", "math", "torch", "numpy", "benchmark"}, tops
    assert all(not name.startswith("benchmark.") or
               name.startswith("benchmark.reference")
               for name in _imports(path))


def test_names_compared_whole():
    assert run.forbidden_modules(["drone_tpu_torch", "drone_tpu_torch.ops",
                                  "jaxtyping", "oracles", "torch"]) == []
    assert run.forbidden_modules(["drone_tpu.env", "jax._src.core", "flax",
                                  "oracle.build"]) == ["drone_tpu", "flax",
                                                       "jax", "oracle"]


@pytest.mark.parametrize("cell", ["mlp_hover.train", "lstm_hover.eval"])
def test_a_run_loads_no_jax(cell):
    """A whole run (small, on the CPU) in a fresh process: its module table
    at the end holds none of the forbidden top-level names."""
    code = textwrap.dedent(f"""
        import sys, torch
        from benchmark import run
        from benchmark.tests import tiny
        code, line = run.execute(tiny.args({cell!r}), torch.device("cpu"),
                                 tiny.adjust)
        assert code == 0 and line, code
        tops = sorted({{m.split(".")[0] for m in sys.modules}})
        print(" ".join(tops))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=S.ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={**__import__("os").environ,
                              "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(out.stdout.split())
    assert "drone_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
