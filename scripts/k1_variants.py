"""Times of K1 (csrc/rollout.cu): the tree's kernel, other checkouts' and
edited copies.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/k1_variants.py <label> [checkout ...]

It builds the tree's rollout.cu, each given checkout's (e.g. a git archive
of a parent commit; its C entry point is the same) and each variant of
VARIANTS (the tree's csrc/ copied, each edit's text found exactly once and
replaced), all nvcc processes started together with the tree's flags, and
prints each library's ptxas registers and spills of rollout_kernel. Then
it times each through the tree's wrapper by CUDA events at the shapes of
SHAPES (hover.toml's env), in the order tree, checkouts, variants,
checkouts again, tree again, and checks every library's planes bitwise
equal to the tree's at each shape. Prints each reading and one JSON line.
"""
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

label = sys.argv[1]
others = [Path(p).resolve() for p in sys.argv[2:]]
sys.path.insert(0, ".")  # the checkout it runs from

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

from drone_tpu_torch import prng  # noqa: E402
from drone_tpu_torch.env import DroneEnv  # noqa: E402
from drone_tpu_torch.ops import cuda_build, cuda_rollout  # noqa: E402
from drone_tpu_torch.utils.config import Config  # noqa: E402

# the kernel's body in the tree, and as two lanes a thread
OLD_BODY = '''  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // the warp's shuffles need all its threads: a warp with a lane below n
  // runs whole, its lanes past n never done and never stored
  if (i - (int)(threadIdx.x & 31) >= pl.n) return;  // no barrier follows
  const bool live = i < pl.n;
  Carry c = {};
  if (live) c = read_carry(pl, i);
  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int t = 0; t < T; ++t) {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    if (WITH_ACTIONS) {
      if (live) {
        const float4 a = actions[(size_t)t * pl.n + i];
        a0 = a.x;
        a1 = a.y;
        a2 = a.z;
        a3 = a.w;
      }
    } else {
      stream_actions(c.k0, c.k1, c.rc, c.stp, a0, a1, a2, a3);
    }
    Advance v;
    float r, epret2;
    bool done;
    int step2;
    env_advance<TASK, INTEG>(c, a0, a1, a2, a3, P, v, r, done, epret2,
                             step2);
    done = done && live;
    Fresh f = {};  // warp_fresh fills it on the lanes that are done
    warp_fresh<TASK>(c, done, P, f);
    env_select(c, v, f, done, epret2, step2);
    accumulate(acc, r, done, epret2, step2);
  }
  if (live) write_back(pl, i, c, acc);
}'''
TWO_LANES = '''  const int i0 = blockIdx.x * 2 * blockDim.x + threadIdx.x;
  if (i0 - (int)(threadIdx.x & 31) >= pl.n) return;  // no barrier follows
  const int idx[2] = {i0, i0 + (int)blockDim.x};
  bool live[2];
  Carry c[2];
  float acc[2][N_STATS];
#pragma unroll
  for (int L = 0; L < 2; ++L) {
    live[L] = idx[L] < pl.n;
    c[L] = Carry{};
    if (live[L]) c[L] = read_carry(pl, idx[L]);
#pragma unroll
    for (int k = 0; k < N_STATS; ++k) acc[L][k] = 0.0f;
  }
  for (int t = 0; t < T; ++t) {
    Advance v[2];
    float r[2], epret2[2];
    bool done[2];
    int step2[2];
#pragma unroll
    for (int L = 0; L < 2; ++L) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      if (WITH_ACTIONS) {
        if (live[L]) {
          const float4 a = actions[(size_t)t * pl.n + idx[L]];
          a0 = a.x;
          a1 = a.y;
          a2 = a.z;
          a3 = a.w;
        }
      } else {
        stream_actions(c[L].k0, c[L].k1, c[L].rc, c[L].stp, a0, a1, a2, a3);
      }
      env_advance<TASK, INTEG>(c[L], a0, a1, a2, a3, P, v[L], r[L], done[L],
                               epret2[L], step2[L]);
      done[L] = done[L] && live[L];
    }
#pragma unroll
    for (int L = 0; L < 2; ++L) {
      Fresh f = {};
      warp_fresh<TASK>(c[L], done[L], P, f);
      env_select(c[L], v[L], f, done[L], epret2[L], step2[L]);
      accumulate(acc[L], r[L], done[L], epret2[L], step2[L]);
    }
  }
#pragma unroll
  for (int L = 0; L < 2; ++L)
    if (live[L]) write_back(pl, idx[L], c[L], acc[L]);
}'''

# name: [(source, text, its replacement), ...]
VARIANTS = {
    "128 threads a block": [
        ("rollout.cu", "constexpr int ROLLOUT_THREADS = 256;",
         "constexpr int ROLLOUT_THREADS = 128;")],
    "64 threads a block": [
        ("rollout.cu", "constexpr int ROLLOUT_THREADS = 256;",
         "constexpr int ROLLOUT_THREADS = 64;")],
    # a warp vote alone: every lane computes its own reset, on the steps
    # where a lane of its warp is done
    "vote only (each lane its own reset)": [
        ("rollout.cu", "    warp_fresh<TASK>(c, done, P, f);",
         "    if (__any_sync(FULL_WARP, done))\n"
         "      fresh_state<TASK>(c.k0, c.k1, c.rc + 1u, P, f);")],
    # two lanes a thread (lanes i and i + blockDim.x of a block of
    # 2 blockDim.x), their steps interleaved for ILP
    "two lanes a thread": [
        ("rollout.cu", OLD_BODY, TWO_LANES),
        ("rollout.cu",
         "const int blocks = (pl.n + ROLLOUT_THREADS - 1) / ROLLOUT_THREADS;",
         "const int blocks = (pl.n + 2 * ROLLOUT_THREADS - 1)\n"
         "                     / (2 * ROLLOUT_THREADS);")],
}
# (lanes, steps, in-kernel actions)
SHAPES = ((65536, 1001, True), (131072, 4096, True), (65536, 64, False))


def build(name, csrc):
    """Start nvcc on csrc/rollout.cu into a temporary library."""
    out = Path(tempfile.mkdtemp()) / "rollout.so"
    proc = subprocess.Popen(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(out),
         str(csrc / "rollout.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    return name, out, proc


def edited_csrc(edits):
    tmp = Path(tempfile.mkdtemp()) / "csrc"
    shutil.copytree(Path("drone_tpu_torch/csrc"), tmp)
    for source, old, new in edits:
        path = tmp / source
        text = path.read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"edit does not apply once to {source}: {old}")
        path.write_text(text.replace(old, new))
    return tmp


jobs = [build("tree", Path("drone_tpu_torch/csrc"))]
jobs += [build(str(o), o / "drone_tpu_torch" / "csrc") for o in others]
jobs += [build(name, edited_csrc(edits)) for name, edits in VARIANTS.items()]
libs = {}
for name, out, proc in jobs:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    entry, lines = None, []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and "rollout_kernelILi0ELi0ELb0E" in entry and (
                "Used " in line or "spill" in line):
            lines.append(line.strip())
    print(f"{label} {name}: rollout_kernel<hover, euler, in-kernel> "
          f"{lines}", flush=True)
    libs[name] = ctypes.CDLL(str(out))

cfg = Config.from_toml("configs/hover.toml")
statics, params = cfg.env.build()
env = DroneEnv(statics.task, statics.integrator, params, device="cuda")
inputs = {}
for n, T, in_kernel in SHAPES:
    acts = None if in_kernel else torch.from_numpy(
        prng.action_stream_np(T, n, seed=3, scale=0.9, bias=0.05)).cuda()
    inputs[(n, T, in_kernel)] = (env.init_batch(0, n), acts)


def readings(lib):
    """{shape: ms} of one library, and its planes at each shape."""
    cuda_build._loaded["rollout"] = lib
    ms, out = {}, {}
    for (n, T, in_kernel), (state, acts) in inputs.items():
        def run():
            return cuda_rollout.rollout_kernel(state, env.params, env.statics,
                                               T, acts)
        key = f"{n} x {T} {'in-kernel' if in_kernel else 'provided'}"
        out[key] = cs.planes(*run())
        ms[key] = cs.cuda_ms(run, reps=10 if n * T < 1e8 else 4)
    return ms, out


order = (["tree"] + [str(o) for o in others] + list(VARIANTS)
         + [str(o) for o in reversed(others)] + ["tree"])
times, reference = [], None
for name in order:
    ms, out = readings(libs[name])
    if reference is None:
        reference = out
    same = all(cs.bitwise_equal(a, b) for key in out
               for a, b in zip(out[key], reference[key]))
    times.append({"name": name, "ms": ms, "bitwise equal to the tree": same})
    print(f"{label} {name}: {ms} bitwise equal to the tree: {same}",
          flush=True)
print(json.dumps({"tree": label, "device": cs.device_line(),
                  "readings": times}), flush=True)
