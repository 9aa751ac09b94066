"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes `build/drone_tpu_torch/<name>-<hash>.so`, a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The hash covers every source in `csrc/`, the flags and the
nvcc path, so an edited source is rebuilt at its next use and a stale
library is never loaded. nvcc is looked up when a kernel is first needed,
never when this module is imported: the CPU tests import every module.

The flags are part of the bitwise contract of the env math (csrc/env.cuh):
no FMA contraction, IEEE division and square root, never fast math.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "drone_tpu_torch"
SOURCES = ("rollout", "acting", "acting_traj", "update", "acting_lstm",
           "update_lstm", "acting_cnn", "update_cnn")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(nvcc: str) -> str:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc.encode())
    return h.hexdigest()[:16]


def library_path(name: str, nvcc: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(nvcc)}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source whose library is missing, all nvcc
    processes started together. Returns {name: library path}. The compiler's
    output (ptxas register and spill counts) is kept in `<library>.log`."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {name: library_path(name, nvcc) for name in names}
    procs = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        libs[name].with_suffix(".so.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{out}")
            continue
        tmp.replace(libs[name])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of csrc/<name>.cu, built on first use."""
    if name not in _loaded:
        lib = build((name,))[name]
        _loaded[name] = ctypes.CDLL(str(lib))
    return _loaded[name]


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
