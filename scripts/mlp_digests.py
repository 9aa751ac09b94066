"""The output digests of the MLP kernels K3, K2 and K5, both arms, and the
build report of their libraries, on one card.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/mlp_digests.py <label> [checkout]

It loads the drone_tpu_torch package of `checkout` (by default the one it
runs from; give a git archive of a parent commit to read that one's
kernels), builds update (K3, K4), acting_traj (K2) and acting (K5) from
its csrc/, and prints each kernel's registers, spills and tensor-core
instructions (HMMA, of them HMMA.16816.F32.BF16 and HMMA.1688.F32.TF32,
from cuobjdump -sass); then the sha256 of each arm's outputs at seeded
inputs, each launched twice: K3 on one full-width minibatch of hover.toml
(numpy-seeded planes, 65,536 lanes x 64 steps, 8 row blocks of 1,024
lanes; [64, 64], on chip) and at [128, 128] (8,192 lanes x 16 steps, 2
row blocks; the fp32 arm's weights off chip), K2 at 65,536 lanes x 64
steps of hover ([64, 64]) and 8,192 x 3 ([128, 128], its fragments read
through L1), and K5 (fp32 only) at 65,536 x 1,001; and one JSON line.
Two checkouts whose kernels compute the same bits print the same digests,
and their instantiations the same registers, spills and HMMA.
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
from drone_tpu_torch.ops import cuda_acting as K5  # noqa: E402
from drone_tpu_torch.ops import cuda_acting_traj as K2  # noqa: E402
from drone_tpu_torch.ops import cuda_build  # noqa: E402
from drone_tpu_torch.ops import cuda_update as K3  # noqa: E402
from drone_tpu_torch.types import default_params  # noqa: E402

OPS = ("HMMA", cs.HMMA_BF16, cs.HMMA_TF32)


def build_report(libs) -> dict:
    """{library: {entry function: [registers, spill line, {opcode:
    instructions}]}}."""
    tool = Path(cuda_build.nvcc_path()).with_name("cuobjdump")
    out = {}
    for name, lib in libs.items():
        rep, entry = {}, None
        for line in lib.with_suffix(".so.log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                rep[entry] = [None, "", dict.fromkeys(OPS, 0)]
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
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z0-9_.]+)", line)
            if entry in rep and m:
                for op in OPS:
                    if m.group(1).startswith(op):
                        rep[entry][2][op] += 1
        out[name] = rep
    return out


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def k3_inputs(n, T, rbl, mb, seed):
    """numpy-seeded planes, advantages and a minibatch's row blocks."""
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(T, 21, n)).astype(np.float32)
    planes[:, 17] = rng.normal(-3.0, 0.5, size=(T, n))             # logp
    planes[:, 20] = (rng.random((T, n)) < 0.02).astype(np.float32)  # done
    advret = rng.normal(size=(2, T, n)).astype(np.float32)
    perm = rng.permutation(n // rbl)[:mb].astype(np.int32)
    return [torch.from_numpy(x).cuda() for x in (planes, advret, perm)]


libs = cuda_build.build(("update", "acting_traj", "acting"))
report = build_report(libs)
for name, rep in report.items():
    for entry, (regs, spill, ops) in sorted(rep.items()):
        print(f"{label} {name} {entry}: {regs} registers, {ops}; {spill}",
              flush=True)

env = DroneEnv("hover", "euler", default_params("hover"), device="cuda")
runs = {}
for hidden, n, T, rbl, mb in (((64, 64), 65536, 64, 1024, 8),
                              ((128, 128), 8192, 16, 1024, 2)):
    model = cs.flat_policy(hidden)
    planes, advret, perm = k3_inputs(n, T, rbl, mb, 2)
    co = K3.UpdateConsts(clip_eps=0.2, vf_clip=0.2, vf_coef=0.5,
                         inv_m=1.0 / (mb * rbl * T))
    for dtype in ("float32", cs.BF16):
        runs[f"K3 {list(hidden)} {dtype}"] = (
            lambda a=(planes, advret, perm, model.flat, hidden, co, rbl,
                      0.001), d=dtype: K3.ppo_update_kernel(
                *a, compute_dtype=d))
    state = env.init_batch(9, n)
    for dtype in ("float32", cs.BF16):
        runs[f"K2 {list(hidden)} {dtype}"] = (
            lambda s=state, m=model, steps=64 if n == 65536 else 3,
            d=dtype: K2.traj_rollout_kernel(
                s, m.flat, m.hidden, env.params, env.statics, steps,
                compute_dtype=d))
policy = cs.seeded_policy(seed=1).cuda()
s1 = env.init_batch(1, 65536)
runs["K5 [64, 64] float32"] = lambda: K5.act_rollout_kernel(
    s1, policy, env.params, env.statics, int(env.params.horizon) + 1)


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
    print(f"{label} {name}: digests {digests[name]}; finite {finite}",
          flush=True)
print(json.dumps({"tree": label, "device": cs.device_line(),
                  "digests": digests, "build": report}), flush=True)
