"""Times of K3, K5 and K2 variants: edited copies of a checkout's kernels,
and K2 at other residencies.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/mlp_variants.py <label> [checkout] [name filter]

For each variant of VARIANTS whose edits all apply to `checkout` (by
default the one it runs from; give a second checkout, e.g. a git archive
of a parent commit, for the variants of that tree) and whose name holds
the filter (default: every name), it copies that checkout's csrc/,
replaces each edit's text (found exactly once) with its new text, builds
update.cu, acting.cu and acting_traj.cu with the checkout's nvcc flags
(together), and times K3 on hover.toml's full-width minibatch, K5 at
65,536 lanes x 1,001 steps and K2 at 65,536 lanes x 64 steps ([64, 64],
hover) through the checkout's wrappers, by CUDA events, each arm (where
the checkout has the bf16 arms: "K3 bf16", "K2 bf16"). A variant may also
set an attribute of ops/cuda_update.py for its readings (an edit whose
source starts with "@": the module, the name, the value). Where the
checkout's K2 has cuda_acting_traj.layout_at, K2 is also timed at each
residency of K2_LAYOUTS (its layout rule replaced by layout_at). The
unedited kernels are read first and again last. Prints each reading and
one JSON line. A variant named "timing only" computes a wrong result: it
says what a part of the kernel costs, not what it could be.
"""
import ctypes
import inspect
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

label = sys.argv[1]
checkout = Path(sys.argv[2] if len(sys.argv) > 2 else ".").resolve()
only = sys.argv[3] if len(sys.argv) > 3 else ""
sys.path.insert(0, str(checkout))
sys.path.insert(1, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from drone_tpu_torch.ops import cuda_build  # noqa: E402

# name: [(source, text, its replacement), ...]
VARIANTS = {
    # the fp32 K2 (one thread a lane, both towers on the CUDA cores) at the
    # tensor-core kernel's residency: 512 lanes a block, one block an SM,
    # 65,536 lanes in one wave
    "K2 fp32 towers, 512 lanes a block": [
        ("acting_traj.cu", "constexpr int TRAJ_THREADS = 128;",
         "constexpr int TRAJ_THREADS = 512;"),
        ("acting_traj.cu", "__global__ void __launch_bounds__(TRAJ_THREADS)\n",
         "__global__ void __launch_bounds__(TRAJ_THREADS, 1)\n")],
    # K2's stored layers a product of 2 n-tiles (fewer registers, the
    # obs rows read twice as often)
    "K2 stored layers by 2 n-tiles": [
        ("acting_traj.cu", "constexpr int TRAJ_NT = 4;",
         "constexpr int TRAJ_NT = 2;")],
    # K2's fold by chunks of 4 n-tiles (the last hidden layer's input rows
    # read half as often, more registers)
    "K2 fold chunks of 4 n-tiles": [
        ("acting_traj.cu", "constexpr int TRAJ_FOLD_NT = 2;",
         "constexpr int TRAJ_FOLD_NT = 4;")],
    "K2 stored layers by 2 n-tiles, fold chunks of 4": [
        ("acting_traj.cu", "constexpr int TRAJ_NT = 4;",
         "constexpr int TRAJ_NT = 2;"),
        ("acting_traj.cu", "constexpr int TRAJ_FOLD_NT = 2;",
         "constexpr int TRAJ_FOLD_NT = 4;")],
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
    "timing only: no tanhf in K3's forward and K5's and K2's towers": [
        ("update.cu", "head ? v : tanhf(v);", "v;"),
        ("tower_mma.cuh",
         "Y[(row0 + n - 8 * nt0) * as + m] = tanhf(acc[i][j][r] + bias[n]);",
         "Y[(row0 + n - 8 * nt0) * as + m] = acc[i][j][r] + bias[n];"),
        ("tower_mma.cuh", "acc[i][j][r] = tanhf(acc[i][j][r] + bias[n]);",
         "acc[i][j][r] = acc[i][j][r] + bias[n];")],
    "timing only: no bias loads in K3's forward": [
        ("update.cu", "acc[i][j][r] + __ldg(bias + n);", "acc[i][j][r];")],
    # K3's bf16 arm on the fp32 arm's grid: 128 blocks, 4 SMs idle
    "K3 bf16 on 128 blocks": [
        ("update.cu", "constexpr int B16_MAX_BLOCKS = 132;",
         "constexpr int B16_MAX_BLOCKS = 128;"),
        ("@cuda_update", "B16_MAX_BLOCKS", 128)],
    "timing only: no tanhf in K2 bf16's towers": [
        ("tower_mma.cuh", "              bf16_bits(tanhf(acc[i][j][r] + "
         "bias[n]));", "              bf16_bits(acc[i][j][r] + bias[n]);"),
        ("tower_mma.cuh", "acc[i][j][r] = tanhf(acc[i][j][r] + bias[n]);",
         "acc[i][j][r] = acc[i][j][r] + bias[n];")],
    "timing only: no tanhf in K3 bf16's forward": [
        ("update.cu", "          v0 = tanhf(v0);\n          v1 = tanhf(v1);\n",
         "")],
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
        ("tower_mma.cuh", "        for (int i = 0; i < 2; ++i) mma_tf32(part[i][j], as_[i], bb[j]);\n"
                      "#pragma unroll\n    for (int j = 0; j < NI; ++j)\n      if (j < nv)\n"
                      "#pragma unroll\n        for (int i = 0; i < 2; ++i) mma_tf32(part[i][j], ab[i], bs[j]);",
         "        for (int i = 0; i < 2; ++i) {}")],
}


# K2's residencies (lanes a block, both towers' fragments staged)
K2_LAYOUTS = {"K2 512 lanes, fragments through L1": (512, 0),
              "K2 256 lanes, fragments staged": (256, 1),
              "K2 256 lanes, fragments through L1 (two blocks an SM)": (256, 0),
              "K2 384 lanes, fragments staged": (384, 1)}
LIBS = ("update", "acting", "acting_traj")


def edited(edits):
    """A built copy of the checkout's update.cu, acting.cu and
    acting_traj.cu with the edits, or None when one of them does not
    apply."""
    tmp = Path(tempfile.mkdtemp())
    shutil.copytree(checkout / "drone_tpu_torch" / "csrc", tmp / "csrc")
    for source, old, new in edits:
        if source.startswith("@"):
            continue
        path = tmp / "csrc" / source
        if not path.exists() or path.read_text().count(old) != 1:
            return None
        text = path.read_text()
        path.write_text(text.replace(old, new))
    procs = {name: subprocess.Popen(
        [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
         str(tmp / f"{name}.so"), str(tmp / "csrc" / f"{name}.cu")],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL) for name in LIBS}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the edited {name}.cu")
    return {name: ctypes.CDLL(str(tmp / f"{name}.so")) for name in LIBS}


from drone_tpu_torch.env import DroneEnv  # noqa: E402
from drone_tpu_torch.ops import cuda_acting, cuda_acting_traj  # noqa: E402
from drone_tpu_torch.ops import cuda_update  # noqa: E402
from drone_tpu_torch.utils.config import Config  # noqa: E402

cfg = Config.from_toml(str(checkout / "configs" / "hover.toml"))
statics, params = cfg.env.build()
env = DroneEnv(statics.task, statics.integrator, params, device="cuda")
model = cs.flat_policy()
planes, advret, perm_mb, co, rbl = cs.hover_minibatch(cfg, model, env)
policy = cs.seeded_policy(seed=1).cuda()
state = env.init_batch(2, 65536)


bf16 = "compute_dtype" in inspect.signature(
    cuda_update.ppo_update_kernel).parameters


def k2_ms(dtype="float32"):
    kw = {"compute_dtype": dtype} if bf16 else {}
    return cs.cuda_ms(lambda: cuda_acting_traj.traj_rollout_kernel(
        state, model.flat, model.hidden, env.params, env.statics, 64, **kw),
        5)


def times(libs, attrs=()):
    cuda_build._loaded.update(libs)
    mods = {"@cuda_update": cuda_update}
    was = [(mods[m], name, getattr(mods[m], name)) for m, name, _ in attrs]
    for m, name, value in attrs:
        setattr(mods[m], name, value)
    out = {"K2": k2_ms(),
           "K3": cs.cuda_ms(lambda: cuda_update.ppo_update_kernel(
               planes, advret, perm_mb, model.flat, model.hidden, co, rbl,
               0.001), 10),
           "K5": cs.cuda_ms(lambda: cuda_acting.act_rollout_kernel(
               state, policy, env.params, env.statics,
               int(env.params.horizon) + 1), 3)}
    if bf16:
        out["K2 bf16"] = k2_ms(cs.BF16)
        out["K3 bf16"] = cs.cuda_ms(lambda: cuda_update.ppo_update_kernel(
            planes, advret, perm_mb, model.flat, model.hidden, co, rbl,
            0.001, compute_dtype=cs.BF16), 10)
    for mod, name, value in was:
        setattr(mod, name, value)
    return out


tree = {name: cuda_build.load(name) for name in LIBS}
out = {"tree": times(tree)}
print(f"{label} tree: {out['tree']}", flush=True)
for name, edits in VARIANTS.items():
    libs = edited(edits) if only in name else None
    if libs is None:
        continue
    out[name] = times(libs, [e for e in edits if e[0].startswith("@")])
    print(f"{label} {name}: {out[name]}", flush=True)
if hasattr(cuda_acting_traj, "layout_at"):
    cuda_build._loaded.update(tree)
    rule = cuda_acting_traj.traj_layout
    for name, (lanes, wsm) in K2_LAYOUTS.items():
        if only in name:
            cuda_acting_traj.traj_layout = (
                lambda hidden, lanes=lanes, wsm=wsm:
                cuda_acting_traj.layout_at(hidden, lanes, wsm))
            out[name] = {"K2": k2_ms()}
            print(f"{label} {name}: {out[name]}", flush=True)
    cuda_acting_traj.traj_layout = rule
out["tree again"] = times(tree)
print(f"{label} tree again: {out['tree again']}", flush=True)
print(json.dumps({"tree": label, "device": cs.device_line(), "ms": out}),
      flush=True)
