"""Products and bytes of lstm_hover's kernels and steps, from its shapes
(the encoder is run.hidden[:1], as the program builds it)."""

from benchmark.harness.shapes import lstm_counts
from benchmark.reference.env import DEFAULTS


def counts(tables: dict, workload: dict) -> tuple[dict, dict]:
    run, tc = tables["run"], tables["train"]
    horizon = int(tables.get("env", {}).get("horizon", DEFAULTS["horizon"]))
    return lstm_counts(run["lstm_hidden"], list(run["hidden"])[:1],
                       tc["num_envs"], tc["horizon"], tc["bptt_horizon"],
                       tc["epochs"], tc["num_minibatches"],
                       workload.get("episodes", 0), horizon + 1)
