"""Times of K3 and K5 variants: edited copies of a checkout's kernels.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/mlp_variants.py <label> [checkout]

For each variant of VARIANTS whose edits all apply to `checkout` (by
default the one it runs from; give a second checkout, e.g. a git archive
of a parent commit, for the variants of that tree), it copies that
checkout's csrc/, replaces each edit's text (found exactly once) with its
new text, builds update.cu and acting.cu with the checkout's nvcc flags,
and times K3 on hover.toml's full-width minibatch and K5 at 65,536 lanes x
1,001 steps ([64, 64], hover) through the checkout's wrappers, by CUDA
events. The unedited kernels are read first and again last. Prints each
reading and one JSON line. A variant named "timing only" computes a wrong
result: it says what a part of the kernel costs, not what it could be.
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

# name: [(source, text, its replacement), ...]
VARIANTS = {
    # the fp32 tower (policy.cuh) at the tensor-core kernel's residency:
    # 512 lanes a block, one block an SM, 65,536 lanes in one wave
    "K5 fp32 tower, 512 lanes a block": [
        ("acting.cu", "constexpr int ACT_THREADS = 128;",
         "constexpr int ACT_THREADS = 512;"),
        ("acting.cu", "__global__ void __launch_bounds__(ACT_THREADS)\n",
         "__global__ void __launch_bounds__(ACT_THREADS, 1)\n")],
    # K3 with 8 warps a block, each unit two m-tiles by four n-tiles
    "K3 256 threads, units of 2 x 4 tiles": [
        ("update.cu", "constexpr int UPD_THREADS = 512;",
         "constexpr int UPD_THREADS = 256;"),
        ("update.cu", "constexpr int UMI = 1, UNI = 4;",
         "constexpr int UMI = 2, UNI = 4;")],
    "timing only: K3's products unguarded (every tile of a unit)": [
        ("update.cu", "      if (i < mv && j < nv) mma_tf32(acc[i][j], as[i], bb[j]);",
         "      mma_tf32(acc[i][j], as[i], bb[j]);"),
        ("update.cu", "      if (i < mv && j < nv) mma_tf32(acc[i][j], ab[i], bs[j]);",
         "      mma_tf32(acc[i][j], ab[i], bs[j]);"),
        ("update.cu", "      if (i < mv && j < nv) mma_tf32(acc[i][j], ab[i], bb[j]);",
         "      mma_tf32(acc[i][j], ab[i], bb[j]);")],
    "K3 k-loops unrolled by 2": [
        ("update.cu", "  for (int k0 = 0; k0 < K; k0 += 8) {\n    uint32_t ab[UMI][4], as[UMI][4], bb[UNI][2], bs[UNI][2];",
         "#pragma unroll 2\n  for (int k0 = 0; k0 < K; k0 += 8) {\n    uint32_t ab[UMI][4], as[UMI][4], bb[UNI][2], bs[UNI][2];")],
    "timing only: no tanhf in K3's forward and K5's tower": [
        ("update.cu", "head ? v : tanhf(v);", "v;"),
        ("acting.cu", "tanhf(acc[i][j][r] + bias[n]);",
         "acc[i][j][r] + bias[n];")],
    "timing only: no bias loads in K3's forward": [
        ("update.cu", "acc[i][j][r] + __ldg(bias + n);", "acc[i][j][r];")],
    "timing only: operands not split (TF32 bits of x as both halves)": [
        ("mma.cuh", "  big = tf32_rna(x) & 0xffffe000u;\n"
                    "  small = tf32_rna(x - __uint_as_float(big));",
         "  big = __float_as_uint(x);\n  small = big;")],
    "timing only: 1xTF32 (one product a pair)": [
        ("update.cu", "      if (i < mv && j < nv) mma_tf32(acc[i][j], as[i], bb[j]);\n"
                      "#pragma unroll\n  for (int i = 0; i < MI; ++i)\n#pragma unroll\n"
                      "    for (int j = 0; j < NI; ++j)\n"
                      "      if (i < mv && j < nv) mma_tf32(acc[i][j], ab[i], bs[j]);",
         "      {}"),
        ("acting.cu", "        for (int i = 0; i < 2; ++i) mma_tf32(part[i][j], as_[i], bb[j]);\n"
                      "#pragma unroll\n    for (int j = 0; j < NI; ++j)\n      if (j < nv)\n"
                      "#pragma unroll\n        for (int i = 0; i < 2; ++i) mma_tf32(part[i][j], ab[i], bs[j]);",
         "        for (int i = 0; i < 2; ++i) {}")],
}


def edited(edits):
    """A built copy of the checkout's update.cu and acting.cu with the
    edits, or None when one of them does not apply."""
    tmp = Path(tempfile.mkdtemp())
    shutil.copytree(checkout / "drone_tpu_torch" / "csrc", tmp / "csrc")
    for source, old, new in edits:
        path = tmp / "csrc" / source
        if not path.exists() or path.read_text().count(old) != 1:
            return None
        text = path.read_text()
        path.write_text(text.replace(old, new))
    libs = {}
    for name in ("update", "acting"):
        lib = tmp / f"{name}.so"
        subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                        "-o", str(lib), str(tmp / "csrc" / f"{name}.cu")],
                       check=True, capture_output=True, text=True)
        libs[name] = ctypes.CDLL(str(lib))
    return libs


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


def times(libs):
    cuda_build._loaded.update(libs)
    return {"K3": cs.cuda_ms(lambda: cuda_update.ppo_update_kernel(
                planes, advret, perm_mb, model.flat, model.hidden, co, rbl,
                0.001), 10),
            "K5": cs.cuda_ms(lambda: cuda_acting.act_rollout_kernel(
                state, policy, env.params, env.statics,
                int(env.params.horizon) + 1), 3)}


tree = {name: cuda_build.load(name) for name in ("update", "acting")}
out = {"tree": times(tree)}
print(f"{label} tree: {out['tree']}", flush=True)
for name, edits in VARIANTS.items():
    libs = edited(edits)
    if libs is None:
        continue
    out[name] = times(libs)
    print(f"{label} {name}: {out[name]}", flush=True)
out["tree again"] = times(tree)
print(f"{label} tree again: {out['tree again']}", flush=True)
print(json.dumps({"tree": label, "device": cs.device_line(), "ms": out}),
      flush=True)
