"""K4's output digests and times at the policy families' parameter counts,
on one card.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/k4_digests.py <label> [checkout]

It loads the drone_tpu_torch package of `checkout` (by default the one it
runs from; give a git archive of a parent commit to read that one's K4)
and prints, at each of chip_smoke.K4_FAMILY_P: chip_smoke.k4_digests (the
sha256 of K4's outputs on seeded inputs, the clip active and inactive),
K4's time by CUDA events (the mean of 2,000 launches after a warm-up, the
wrapper's host work included, as the kernels line times it) and its
device time (torch.profiler, the mean adam_kernel duration over 200
launches); then the same at chip_smoke.K4_WIDE_P where the package takes
it, and one JSON line. Run two checkouts in one call, parent, change,
change, parent, to compare their times on one card.
"""
import json
import sys

sys.path.insert(0, ".")  # the checkout it runs from

import chip_smoke as cs  # noqa: E402

label = sys.argv[1]
if len(sys.argv) > 2:
    sys.path.insert(0, sys.argv[2])  # its package before this checkout's

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from drone_tpu_torch.ops import cuda_update as K4  # noqa: E402


def times(P):
    theta, grads, mu, nu = (torch.from_numpy(x).cuda()
                            for x in cs.k4_inputs(P))
    count = torch.full((), 5.0, device="cuda")
    ac, sched = K4.AdamConsts(), K4.LrSchedule(3e-4, 2400, True)

    def call():
        K4.fused_adam_kernel(theta, grads, mu, nu, count, ac, sched, [P])

    ms = cs.cuda_ms(call, reps=2000)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(200):
            call()
        torch.cuda.synchronize()
    dev = [getattr(e, "device_time", None) or getattr(e, "cuda_time", 0)
           for e in prof.events() if "adam_kernel" in e.name]
    dev = [t for t in dev if t > 0]
    return ms, (sum(dev) / len(dev) / 1e3 if dev else None)


out = {"tree": label, "device": cs.device_line(), "families": {}}
sizes = dict(cs.K4_FAMILY_P)
try:
    K4.adam_blocks(cs.K4_WIDE_P)
    sizes["wide"] = cs.K4_WIDE_P
except ValueError:
    pass
for family, P in sizes.items():
    digests = cs.k4_digests(P)
    ms, device_ms = times(P)
    out["families"][family] = {"P": P, "digests": digests, "ms": ms,
                               "device_ms": device_ms}
    print(f"{label} K4 {family} P {P}: digests {digests}, {ms:.5f} ms a "
          f"call, device {device_ms} ms", flush=True)
print(json.dumps(out), flush=True)
