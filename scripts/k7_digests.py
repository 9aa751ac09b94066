"""K7's output digests, fp32 and bf16, both encoder arms, and the build
report of the recurrent kernels, on one card.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/k7_digests.py <label> [checkout]

It loads the drone_tpu_torch package of `checkout` (by default the one it
runs from; give a git archive of a parent commit to read that one's K7),
builds acting_lstm (K6, K8) and update_lstm (K7) from its csrc/, and
prints each kernel's registers, spills and tensor-core instructions (HMMA,
from cuobjdump -sass); then the sha256 of K7's fp32 gradients and stat
sums on numpy-seeded inputs at the recurrent path's shape (65,536 lanes x
128 steps, bptt 16, a minibatch of 16 row blocks of 1,024 lanes, H 128),
for the dense encoder (64,) and the CNN arm, each launched twice, and the
same of its bf16 arm (compute_dtype="bfloat16", "dense bf16" and "cnn
bf16"); and one JSON line. Two checkouts whose K7 arm computes the same
bits print the same digests; their fp32 instantiations the same registers
and HMMA.
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

from drone_tpu_torch.models.lstm import lstm_kernel_offsets  # noqa: E402
from drone_tpu_torch.ops import cuda_build  # noqa: E402
from drone_tpu_torch.ops import cuda_update_lstm as K7  # noqa: E402
from drone_tpu_torch.ops.cuda_acting_cnn import KERNEL_ARCH  # noqa: E402
from drone_tpu_torch.ops.cuda_update import UpdateConsts  # noqa: E402

N, T, BPTT, H, RBL, MB = 65536, 128, 16, 128, 1024, 16


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


def inputs(encoder, seed):
    """numpy-seeded planes, advantages, anchors, minibatch and weights."""
    rng = np.random.default_rng(seed)
    _, P = lstm_kernel_offsets(H, encoder)
    planes = rng.normal(size=(T, 21, N)).astype(np.float32)
    planes[:, 17] = rng.normal(-3.0, 0.5, size=(T, N))         # logp
    planes[:, 20] = (rng.random((T, N)) < 0.02).astype(np.float32)  # done
    advret = rng.normal(size=(2, T, N)).astype(np.float32)
    snap = (0.5 * rng.normal(size=(T // BPTT, 2, H, N))).astype(np.float32)
    perm = rng.permutation(N // RBL)[:MB].astype(np.int32)
    theta = (0.05 * rng.normal(size=P)).astype(np.float32)
    offs, _ = lstm_kernel_offsets(H, encoder)
    theta[offs["log_std"]:offs["log_std"] + 4] = -0.5
    return [torch.from_numpy(x).cuda() for x in (planes, advret, snap, perm,
                                                 theta)]


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


libs = cuda_build.build(("acting_lstm", "update_lstm"))
report = build_report(libs)
for name, rep in report.items():
    for entry, (regs, spill, hmma) in sorted(rep.items()):
        print(f"{label} {name} {entry}: {regs} registers, {hmma} HMMA; "
              f"{spill}", flush=True)
co = UpdateConsts(clip_eps=0.2, vf_clip=0.2, vf_coef=0.5,
                  inv_m=1.0 / (MB * RBL * T))
digests = {}
for arm, encoder, seed in (("dense", (64,), 1), ("cnn", KERNEL_ARCH, 2)):
    planes, advret, snap, perm, theta = inputs(encoder, seed)
    args = (planes, advret, snap, perm, theta, (H, encoder), co, RBL, BPTT,
            0.001)
    for dtype, key in (("float32", arm), ("bfloat16", f"{arm} bf16")):
        g, st = K7.lstm_update_kernel(*args, compute_dtype=dtype)
        g2, st2 = K7.lstm_update_kernel(*args, compute_dtype=dtype)
        torch.cuda.synchronize()
        digests[key] = [digest(g, st), digest(g2, st2)]
        print(f"{label} K7 {dtype} {arm}: digests {digests[key]}; grads "
              f"finite {bool(torch.isfinite(g).all())}, |max| "
              f"{float(g.abs().max()):.4g}", flush=True)
    del planes, advret, snap, args
print(json.dumps({"tree": label, "device": cs.device_line(),
                  "digests": digests, "build": report}), flush=True)
