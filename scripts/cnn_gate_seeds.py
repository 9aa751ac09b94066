"""The CNN learning gate's training from several seeds, on one card.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/cnn_gate_seeds.py <label> [checkout]

It runs chip_smoke.py's phase-24 training (`cnn_gate_run`) from seeds 0-11
with the drone_tpu_torch package of `checkout` (by default the one it runs
from; give a second checkout, e.g. a git archive of a parent commit, to
train that one's kernels under the same gate) and prints each seed's two
readings: the lowest 10-update mean of the value loss over that of updates
3-12 (the gate asks for less than 0.5 in every run) and the mean reward's
rise from the first 10 updates to the last 10 (more than 0 in every run,
more than 0.2 in the mean over the gate's four seeds). Then the gate's
verdict (`cnn_gate_verdict`) on each group of four seeds, 0-3, 4-7 and
8-11, and one JSON line.
"""
import json
import sys

sys.path.insert(0, ".")  # the checkout it runs from

import chip_smoke as cs  # noqa: E402

label = sys.argv[1]
if len(sys.argv) > 2:
    sys.path.insert(0, sys.argv[2])  # its package before this checkout's
runs, readings = [], {}
for seed in range(12):
    runs.append(cs.cnn_gate_run(seed))
    early, lowest, _, r_first, r_last, finite = runs[-1]
    readings[seed] = {"value_loss_ratio": lowest / early,
                      "reward_rise": r_last - r_first, "finite": finite}
    print(f"{label} seed {seed}: {readings[seed]}", flush=True)
verdicts = {}
for first in range(0, 12, 4):
    passed, rise = cs.cnn_gate_verdict(runs[first:first + 4])
    verdicts[f"{first}-{first + 3}"] = {"passed": passed, "mean_rise": rise}
    print(f"{label} seeds {first}-{first + 3}: gate passed {passed}, mean "
          f"rise {rise}", flush=True)
print(json.dumps({"tree": label, "device": cs.device_line(),
                  "runs": readings, "verdicts": verdicts}), flush=True)
