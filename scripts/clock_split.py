"""Where K3 and K5 spend their time: each phase's clock64 cycles in block 0.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/clock_split.py <label> [checkout]

It copies the csrc/ of `checkout` (by default the one it runs from; give a
second checkout, e.g. a git archive of a parent commit, to split that
one's kernels) into a temporary directory and inserts a probe after each
phase of update.cu's K3 and acting.cu's K5: thread 0 of block 0 adds the
clock64 cycles since its last probe to that phase's counter. It builds
both copies with that checkout's nvcc flags, runs K3 once on hover.toml's
full-width minibatch and K5 once at 65,536 lanes x 1,001 steps (hover,
[64, 64]) through that checkout's wrappers, after one warm-up launch each,
and prints each phase's cycles and share of block 0's total, one JSON
line. The probes are anchored on lines of the sources, per kernel design
the script knows (the fp32 kernels and the tensor-core ones): a source in
which no design's anchors are each found once fails. The probed copies
run slower than the kernels; the shares are what the split is for.
"""
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

label = sys.argv[1]
checkout = Path(sys.argv[2] if len(sys.argv) > 2 else ".").resolve()
sys.path.insert(0, str(checkout))
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from drone_tpu_torch.ops import cuda_build  # noqa: E402

PROBES = r"""
#include <cuda_runtime.h>
__device__ unsigned long long drone_clk[16];
#define CLK_START long long drone_t0 = clock64();
#define CLK(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) { \
  const long long drone_t1 = clock64(); \
  drone_clk[k] += (unsigned long long)(drone_t1 - drone_t0); \
  drone_t0 = drone_t1; } } while (0)
extern "C" int drone_clk_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, drone_clk, sizeof(drone_clk));
}
extern "C" int drone_clk_zero() {
  const unsigned long long z[16] = {0};
  return (int)cudaMemcpyToSymbol(drone_clk, z, sizeof(z));
}
"""

# per source: the phase names, then (anchor, probe put after it) for each
# tree the script knows (the fp32 kernels, the tensor-core ones); the tree
# whose every anchor is present once is taken. The tensor-core K3's
# probes name its layers (at two hidden layers: 0, 1 and the head).
SPLITS = {
    "update": [
        (("load", "actor fwd", "critic fwd", "head grads", "stat sums",
          "actor bwd", "critic bwd"), [
            ("  float st_acc = 0.0f;\n  bool first = true;\n",
             "  CLK_START\n"),
            ("      sm[row * SP + s] = v;\n    }\n    __syncthreads();\n",
             "    CLK(0);\n"),
            ("    tower_fwd(sm, ta, RA, HM, A.theta);\n", "    CLK(1);\n"),
            ("    tower_fwd(sm, tc, RC, HV, A.theta);\n", "    CLK(2);\n"),
            ("sm[(IN + k) * SP + s] = st[k];\n    }\n    __syncthreads();\n",
             "    CLK(3);\n"),
            ("      st_acc = st_acc + tile_sum;\n    }\n", "    CLK(4);\n"),
            ("    tower_bwd(sm, ta, RA, HM, A.theta, part, first);\n"
             "    __syncthreads();\n", "    CLK(5);\n"),
            ("    tower_bwd(sm, tc, RC, HV, A.theta, part, first);\n"
             "    __syncthreads();\n", "    CLK(6);\n")]),
        (("load", "fwd 0", "fwd 1", "fwd head", "head grads", "stat sums",
          "dW 0", "dW 1", "dW head", "dX 1", "dX head"), [
            ("  float st_acc = 0.0f;\n  __syncthreads();\n",
             "  CLK_START\n"),
            (": 0.0f;\n    __syncthreads();\n", "    CLK(0);\n"),
            ("      layer_fwd(act, lo, l, A.theta, wb, ws);\n"
             "      __syncthreads();\n", "      CLK(1 + l);\n"),
            ("stat_part[w][4 + lane] = sv[4];\n    }\n    __syncthreads();\n",
             "    CLK(4);\n"),
            ("      st_acc = st_acc + tile_sum;\n    }\n", "    CLK(5);\n"),
            ("      layer_dw(act, lo, l, sums);\n      __syncthreads();\n",
             "      CLK(6 + l);\n"),
            ("      layer_dx(act, lo, l, wb, ws);\n      __syncthreads();\n",
             "      CLK(8 + l);\n")]),
        # the same phases, the kernel templated on its bf16 arm
        (("load", "fwd 0", "fwd 1", "fwd head", "head grads", "stat sums",
          "dW 0", "dW 1", "dW head", "dX 1", "dX head"), [
            ("  float st_acc = 0.0f;\n  __syncthreads();\n",
             "  CLK_START\n"),
            (": 0.0f;\n    __syncthreads();\n", "    CLK(0);\n"),
            ("      layer_fwd<BF16>(act, lo, l, A.theta, wb, ws);\n"
             "      __syncthreads();\n", "      CLK(1 + l);\n"),
            ("stat_part[w][4 + lane] = sv[4];\n    }\n    __syncthreads();\n",
             "    CLK(4);\n"),
            ("      st_acc = st_acc + tile_sum;\n    }\n", "    CLK(5);\n"),
            ("      layer_dw<BF16>(act, lo, l, sums);\n      __syncthreads();\n",
             "      CLK(6 + l);\n"),
            ("      layer_dx<BF16>(act, lo, l, wb, ws);\n      __syncthreads();\n",
             "      CLK(8 + l);\n")]),
    ],
    "acting": [
        (("observe", "tower", "noise", "env step", "statistics"), [
            ("  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};\n",
             "  CLK_START\n"),
            ("    for (int k = 0; k < OBS_DIM; ++k) col_obs[k * B] = o[k];\n",
             "    CLK(0);\n"),
            ("    tower<4>(sw, tw, col_obs, col_a, col_b, B, a);\n",
             "    CLK(1);\n"),
            ("a[k] = a[k] + tw.std[k] * z[k];\n    }\n", "    CLK(2);\n"),
            ("                          step2);\n", "    CLK(3);\n"),
            ("    accumulate(acc, r, done, epret2, step2);\n",
             "    CLK(4);\n")]),
        (("observe", "tower", "noise", "env step", "statistics"), [
            ("  float acc[N_STATS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};\n",
             "  CLK_START\n"),
            ("live ? o[k] : 0.0f;\n    __syncwarp();\n", "    CLK(0);\n"),
            ("    warp_tower(lo, W, act, a);\n", "    CLK(1);\n"),
            ("a[k] = a[k] + lo.std[k] * z[k];\n    }\n", "    CLK(2);\n"),
            ("                          step2);\n", "    CLK(3);\n"),
            ("    accumulate(acc, r, done, epret2, step2);\n",
             "    CLK(4);\n")]),
    ],
}


def probe(src: str, trees):
    """The source with its probes, and the phase names of its tree."""
    for names, anchors in trees:
        if any(src.count(anchor) != 1 for anchor, _ in anchors):
            continue
        for anchor, text in anchors:
            src = src.replace(anchor, anchor + text)
        return src, names
    raise SystemExit("no known tree's anchors are each in the source once")


tmp = Path(tempfile.mkdtemp())
shutil.copytree(checkout / "drone_tpu_torch" / "csrc", tmp / "csrc")
(tmp / "probes.cuh").write_text(PROBES)
names, libs = {}, {}
for name, trees in SPLITS.items():
    path = tmp / "csrc" / f"{name}.cu"
    text, names[name] = probe(path.read_text(), trees)
    path.write_text(text)
    lib = tmp / f"{name}.so"
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                    "-include", str(tmp / "probes.cuh"), "-o", str(lib),
                    str(path)], check=True, capture_output=True, text=True)
    libs[name] = ctypes.CDLL(str(lib))
    cuda_build._loaded[name] = libs[name]  # the wrappers launch the copy

import torch  # noqa: E402

from drone_tpu_torch.env import DroneEnv  # noqa: E402
from drone_tpu_torch.ops import cuda_acting, cuda_update  # noqa: E402
from drone_tpu_torch.utils.config import Config  # noqa: E402

cfg = Config.from_toml(str(checkout / "configs" / "hover.toml"))
statics, params = cfg.env.build()
env = DroneEnv(statics.task, statics.integrator, params, device="cuda")
model = cs.flat_policy()
planes, advret, perm_mb, co, rbl = cs.hover_minibatch(cfg, model, env)
policy = cs.seeded_policy(seed=1).cuda()
state = env.init_batch(2, 65536)
runs = {
    "update": lambda: cuda_update.ppo_update_kernel(
        planes, advret, perm_mb, model.flat, model.hidden, co, rbl, 0.001),
    "acting": lambda: cuda_acting.act_rollout_kernel(
        state, policy, env.params, env.statics,
        int(env.params.horizon) + 1),
}
out = {}
for name, run in runs.items():
    lib = libs[name]
    run()
    torch.cuda.synchronize()
    lib.drone_clk_zero()
    run()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 16)()
    if lib.drone_clk_read(buf) != 0:
        raise SystemExit(f"{name}: reading the counters failed")
    cycles = {n: int(buf[i]) for i, n in enumerate(names[name])}
    total = sum(cycles.values())
    out[name] = {"cycles": cycles, "total": total,
                 "share": {n: c / total for n, c in cycles.items()}}
    print(f"{label} {name}: {out[name]}", flush=True)
print(json.dumps({"tree": label, "device": cs.device_line(), "split": out}),
      flush=True)
shutil.rmtree(tmp)
