"""The fp32 output digests of the patch-CNN tower's kernels, and the build
report of every library that includes csrc/cnn_mma.cuh, on one card.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/tower_digests.py <label> [checkout]

It loads the drone_tpu_torch package of `checkout` (by default the one it
runs from; give a git archive of a parent commit to read that one's
kernels), builds acting_cnn (K11, K9), update_cnn (K10), acting_lstm (K8,
K6) and update_lstm (K7) from its csrc/, and prints each kernel's
registers, spills and tensor-core instructions (HMMA, from cuobjdump
-sass); then the sha256 of the fp32 arms' outputs on numpy-seeded weights
at their paths' shapes, each launched twice: K10 on one minibatch of the
CNN path (65,536 lanes x 128 steps, numpy-seeded planes, 16 row blocks of
1,024 lanes), K9 (65,536 x 128) and K11 (65,536 x 1,001) on hover, and the
CNN arms of K8 (65,536 x 1,001) and K6 (65,536 x 128, bptt 16) at hidden
128; and one JSON line. scripts/k7_digests.py covers K7's fp32 outputs.
Two checkouts whose fp32 tower kernels compute the same bits print the
same digests, and their fp32 instantiations the same registers and HMMA.
"""
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, ".")  # the checkout it runs from

import chip_smoke as cs  # noqa: E402

label = sys.argv[1]
if len(sys.argv) > 2:
    sys.path.insert(0, sys.argv[2])  # its package before this checkout's

import numpy as np  # noqa: E402
import torch  # noqa: E402

from drone_tpu_torch.env import DroneEnv  # noqa: E402
from drone_tpu_torch.models.cnn import cnn_kernel_offsets  # noqa: E402
from drone_tpu_torch.models.lstm import lstm_kernel_offsets  # noqa: E402
from drone_tpu_torch.ops import cuda_acting_cnn as K11  # noqa: E402
from drone_tpu_torch.ops import cuda_acting_lstm as K8  # noqa: E402
from drone_tpu_torch.ops import cuda_build  # noqa: E402
from drone_tpu_torch.ops import cuda_update_cnn as K10  # noqa: E402
from drone_tpu_torch.ops.cuda_acting_cnn import KERNEL_ARCH  # noqa: E402
from drone_tpu_torch.ops.cuda_update import UpdateConsts  # noqa: E402
from drone_tpu_torch.types import default_params  # noqa: E402

N, T, RBL, MB, H = 65536, 128, 1024, 16, 128


def build_report(libs) -> dict:
    """{library: {entry function: [registers, spill line, HMMA]}}."""
    tool = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    out = {}
    for name, lib in libs.items():
        rep, entry = {}, None
        for line in lib.with_suffix(".so.log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                rep[entry] = [None, "", 0]
            elif entry and "spill stores" in line:
                rep[entry][1] = line.strip()
            elif entry and "Used " in line:
                rep[entry][0] = int(line.split("Used ")[1].split()[0])
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        entry = None
        for line in sass.splitlines():
            if "Function :" in line:
                entry = line.split("Function :")[1].strip()
            elif entry in rep and re.search(r"\bHMMA", line):
                rep[entry][2] += 1
        out[name] = rep
    return out


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def flat(P, ls_off, seed):
    """numpy-seeded weights: 0.05 N(0, 1), log_std -0.5."""
    theta = (0.05 * np.random.default_rng(seed).normal(size=P)).astype(
        np.float32)
    theta[ls_off:ls_off + 4] = -0.5
    return torch.from_numpy(theta).cuda()


def k10_inputs(seed):
    """numpy-seeded planes, advantages and minibatch of the CNN path."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(T, 21, N)).astype(np.float32)
    planes[:, 17] = rng.normal(-3.0, 0.5, size=(T, N))             # logp
    planes[:, 20] = (rng.random((T, N)) < 0.02).astype(np.float32)  # done
    advret = rng.normal(size=(2, T, N)).astype(np.float32)
    perm = rng.permutation(N // RBL)[:MB].astype(np.int32)
    return [torch.from_numpy(x).cuda() for x in (planes, advret, perm)]


libs = cuda_build.build(("acting_cnn", "update_cnn", "acting_lstm",
                         "update_lstm"))
report = build_report(libs)
for name, rep in report.items():
    for entry, (regs, spill, hmma) in sorted(rep.items()):
        print(f"{label} {name} {entry}: {regs} registers, {hmma} HMMA; "
              f"{spill}", flush=True)

offs, P = cnn_kernel_offsets(KERNEL_ARCH)
theta = flat(P, offs["log_std"], 1)
env = DroneEnv("hover", "euler", default_params("hover"), device="cuda")
runs = {}
planes, advret, perm = k10_inputs(2)
co = UpdateConsts(clip_eps=0.2, vf_clip=0.2, vf_coef=0.5,
                  inv_m=1.0 / (MB * RBL * T))
runs["K10"] = lambda: K10.ppo_cnn_update_kernel(
    planes, advret, perm, theta, KERNEL_ARCH, co, RBL, 0.001)
s9 = env.init_batch(9, N)
runs["K9"] = lambda: K11.traj_cnn_rollout_kernel(
    s9, theta, KERNEL_ARCH, env.params, env.statics, T)
s1 = env.init_batch(1, N)
runs["K11"] = lambda: K11.cnn_act_rollout_kernel(
    s1, theta, KERNEL_ARCH, env.params, env.statics,
    int(env.params.horizon) + 1)
loffs, LP = lstm_kernel_offsets(H, KERNEL_ARCH)
ltheta = flat(LP, loffs["log_std"], 3)
arch = (H, KERNEL_ARCH)
carry = (torch.zeros(N, H, device="cuda"), torch.zeros(N, H, device="cuda"))
runs["K8 cnn"] = lambda: K8.lstm_act_rollout_kernel(
    s1, ltheta, arch, carry, env.params, env.statics,
    int(env.params.horizon) + 1)
runs["K6 cnn"] = lambda: K8.traj_lstm_rollout_kernel(
    s9, ltheta, arch, carry, env.params, env.statics, T, 16)


def tensors(out):
    """The tensors of a kernel's outputs (an EnvState by its fstate)."""
    flat_out = []
    for x in out if isinstance(out, tuple) else (out,):
        if isinstance(x, tuple):
            flat_out += tensors(x)
        elif hasattr(x, "fstate"):
            flat_out.append(x.fstate())
        elif x is not None:
            flat_out.append(x)
    return flat_out


digests = {}
for name, run in runs.items():
    a = tensors(run())
    b = tensors(run())
    torch.cuda.synchronize()
    digests[name] = [digest(*a), digest(*b)]
    finite = all(bool(torch.isfinite(t.float()).all()) for t in a)
    print(f"{label} {name} fp32: digests {digests[name]}; finite {finite}",
          flush=True)
print(json.dumps({"tree": label, "device": cs.device_line(),
                  "digests": digests, "build": report}), flush=True)
