"""Products and bytes of mlp_hover's kernels and steps, from its shapes."""

from benchmark.harness.shapes import mlp_counts
from benchmark.reference.env import DEFAULTS


def counts(tables: dict, workload: dict) -> tuple[dict, dict]:
    tc = tables["train"]
    horizon = int(tables.get("env", {}).get("horizon", DEFAULTS["horizon"]))
    return mlp_counts(tables["run"]["hidden"], tc["num_envs"], tc["horizon"],
                      tc["epochs"], tc["num_minibatches"],
                      workload.get("episodes", 0), horizon + 1)
