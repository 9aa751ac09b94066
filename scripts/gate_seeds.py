"""A learning gate's training from several seeds, on one card.

Run from the root of a checkout on a machine with an H100:

    python3 scripts/gate_seeds.py <family> <label> [checkout]

family is mlp (phase 10) or one of chip_smoke.GATES: cnn (phase 24), lstm
(phase 17) or cnn_lstm (phase 31); with "_bf16" after it (mlp_bf16,
lstm_bf16, ...) the gate trains under run.compute_dtype=bfloat16 (phases
46 and 51). It runs that gate's training from seeds
0-11 with the drone_tpu_torch package of `checkout` (by default the one it
runs from;
give a second checkout, e.g. a git archive of a parent commit, to train
that one's kernels under the same gate) and prints each seed's readings:
the lowest value-loss mean over that of the early updates, the mean
reward's rise from the first updates to the last, and whether the one-run
rule (`gate_passes`, the gate's thresholds) passes. Then the four-run form
(`gate_verdict`: every run falling, rising and finite, the rises' mean
above the gate's threshold) on each group of four seeds, 0-3, 4-7 and
8-11, and one JSON line. The MLP gate is a threshold within a budget
(`mlp_gate_run`): each seed's reading is the updates it took and the last
5 updates' mean reward, its rule that mean above MLP_GATE_REWARD within
MLP_GATE_UPDATES updates.
"""
import json
import statistics
import sys

sys.path.insert(0, ".")  # the checkout it runs from

import chip_smoke as cs  # noqa: E402

family, label = sys.argv[1], sys.argv[2]
dtype = "bfloat16" if family.endswith("_bf16") else "float32"
family = family.removesuffix("_bf16")
if len(sys.argv) > 3:
    sys.path.insert(0, sys.argv[3])  # its package before this checkout's
if family == "mlp":
    readings = {}
    for seed in range(12):
        updates, mean5, first5, finite = cs.mlp_gate_run(seed, dtype)
        readings[seed] = {"updates": updates, "reward_last5": mean5,
                          "reward_first5": first5, "finite": finite,
                          "one_run_rule": mean5 > cs.MLP_GATE_REWARD
                          and finite}
        print(f"mlp {dtype} {label} seed {seed}: {readings[seed]}",
              flush=True)
    took = [r["updates"] for r in readings.values()]
    print(json.dumps({"family": family, "dtype": dtype, "tree": label,
                      "device": cs.device_line(), "runs": readings,
                      "one_run_failures": sum(not r["one_run_rule"]
                                              for r in readings.values()),
                      "updates_mean": statistics.mean(took),
                      "updates_max": max(took)}), flush=True)
    sys.exit(0)
run_seed, fall, rise = cs.GATES[family]
runs, readings = [], {}
for seed in range(12):
    runs.append(run_seed(seed, dtype))
    early, lowest, _, r_first, r_last, finite = runs[-1]
    readings[seed] = {"value_loss_ratio": lowest / early,
                      "reward_rise": r_last - r_first, "finite": finite,
                      "one_run_rule": cs.gate_passes(runs[-1], fall, rise)}
    print(f"{family} {dtype} {label} seed {seed}: {readings[seed]}",
          flush=True)
rises = [r["reward_rise"] for r in readings.values()]
verdicts = {}
for first in range(0, 12, 4):
    passed, mean_rise = cs.gate_verdict(runs[first:first + 4], fall, rise)
    verdicts[f"{first}-{first + 3}"] = {"passed": passed,
                                        "mean_rise": mean_rise}
    print(f"{family} {dtype} {label} seeds {first}-{first + 3}: four-run gate "
          f"passed {passed}, mean rise {mean_rise}", flush=True)
print(json.dumps({"family": family, "dtype": dtype, "tree": label,
                  "device": cs.device_line(), "runs": readings,
                  "one_run_failures": sum(not r["one_run_rule"]
                                          for r in readings.values()),
                  "rise_mean": statistics.mean(rises),
                  "rise_sd": statistics.stdev(rises), "verdicts": verdicts}),
      flush=True)
