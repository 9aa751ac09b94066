"""Small sizes of the cells for CPU tests: the cells' own configurations
with fewer lanes, a shorter horizon, narrower towers and a shorter env
horizon."""

from __future__ import annotations

import copy


def adjust(tables: dict, workload: dict):
    tables = copy.deepcopy(tables)
    tables["train"].update(num_envs=1024, horizon=8, epochs=2)
    if tables["run"].get("policy") == "lstm":
        tables["train"].update(bptt_horizon=4, num_minibatches=2)
        tables["run"].update(lstm_hidden=16, hidden=[16, 16])
    else:
        tables["run"].update(hidden=[16, 16])
    tables["env"]["horizon"] = 40
    return tables, dict(workload, episodes=256)


def args(cell: str, seed: int = 3_000_000_019, trace: int = 0):
    from benchmark import run

    return run.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                      "0.3", "--trace", str(trace)])


CELLS = ("mlp_hover.train", "lstm_hover.train", "mlp_hover.eval",
         "lstm_hover.eval")
