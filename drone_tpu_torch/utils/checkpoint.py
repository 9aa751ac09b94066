"""Checkpoints in the port's own format: `torch.save` of a dict at
`<dir>/<step>/params.pt`.

Counterpart of `drone_tpu/utils/checkpoint.py`. A policy checkpoint holds
{"params": state_dict}; a training checkpoint holds the whole runner for an
exact resume: params, the fused optimizer state (count, mu, nu), the env
state, the permutation generator's and the noise generator's states and
update_idx, and for the recurrent trainers the LSTM carry (c, h). Every
trainer keeps the same state (the flat moments K4 updates), so a
checkpoint of the scan trainer resumes under the megakernel trainer and
the reverse, with no conversion. Either kind
serves `restore_raw()["params"]`, which is all evaluation needs. The
newest `max_to_keep` steps are kept.

A data-parallel run saves its global runner: every rank's lanes gathered
in rank order (`parallel.mesh.gather_runner`), rank 0's generators, and
the other ranks' generator states beside them; restored with its mesh,
each rank takes its own lanes and generators back.
"""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path

import torch
from torch import nn

from drone_tpu_torch import env as env_mod
from drone_tpu_torch.ppo import RunnerState
from drone_tpu_torch.ppo_rnn import RecurrentRunnerState
from drone_tpu_torch.types import EnvState

_FILE = "params.pt"


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class Checkpointer:
    """Restore paths create nothing: a caller with a wrong directory gets
    FileNotFoundError, not an empty run directory on disk."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.dir = Path(directory).resolve()
        self.max_to_keep = max_to_keep

    def save(self, step: int, obj, rank_generators=None) -> Path:
        """Save a RunnerState (the whole runner), or an nn.Module's or a
        state dict's tensors (the policy alone), as step `step`.
        rank_generators: the (permutation, noise) generator states of ranks
        1 .. world - 1 of a data-parallel run."""
        if isinstance(obj, RunnerState):
            count, mu, nu = obj.opt_state
            data = {
                "params": {k: _cpu(v)
                           for k, v in obj.params.state_dict().items()},
                "opt_state": {"count": _cpu(count), "mu": _cpu(mu),
                              "nu": _cpu(nu)},
                "env_state": {f.name: _cpu(getattr(obj.env_state, f.name))
                              for f in dataclasses.fields(EnvState)},
                "generator": obj.generator.get_state(),
                "noise_generator": obj.noise_generator.get_state(),
                "update_idx": int(obj.update_idx),
            }
            if isinstance(obj, RecurrentRunnerState):
                data["carry"] = {"c": _cpu(obj.carry[0]),
                                 "h": _cpu(obj.carry[1])}
            if rank_generators:
                data["rank_generators"] = list(rank_generators)
        else:
            params = obj.state_dict() if isinstance(obj, nn.Module) else obj
            data = {"params": {k: _cpu(v) for k, v in params.items()}}
        path = self.dir / str(int(step)) / _FILE
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        torch.save(data, tmp)
        tmp.replace(path)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self.dir / str(old))
        return path

    def steps(self) -> list[int]:
        if not self.dir.is_dir():
            return []
        return sorted(int(d.name) for d in self.dir.iterdir()
                      if d.name.isdigit() and (d / _FILE).is_file())

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_raw(self, step: int | None = None):
        """(the saved dict of CPU tensors, step) of `step` or the latest
        one; `["params"]` is the policy's state dict."""
        if not self.dir.is_dir():
            raise FileNotFoundError(f"no checkpoint directory {self.dir}")
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        raw = torch.load(self.dir / str(int(step)) / _FILE, map_location="cpu",
                         weights_only=True)
        return raw, step

    def restore(self, template: RunnerState, step: int | None = None,
                mesh=None):
        """Restore a training checkpoint into the buffers of `template`
        (same model widths and lane count), in place. Returns (runner,
        step). mesh: a data-parallel run's parallel.mesh.Mesh; the
        template holds the rank's lanes, and the rank takes its lanes of
        the saved global runner and its own generators. The checkpoint must
        come from a run of the same world size (RuntimeError otherwise)."""
        raw, step = self.restore_raw(step)
        if "opt_state" not in raw:
            raise RuntimeError(f"checkpoint {self.dir}/{step} holds a policy "
                               f"only, not a training run")
        params = template.params
        try:
            params.load_state_dict(raw["params"])
        except RuntimeError as e:
            raise RuntimeError(
                f"checkpoint at {self.dir} does not fit this run's model "
                f"(different policy or hidden sizes?)") from e
        count, mu, nu = template.opt_state
        saved_env = raw["env_state"]
        saved_carry = raw.get("carry")
        gen_states = (raw["generator"], raw["noise_generator"])
        ranks = raw.get("rank_generators", [])
        world = 1 if mesh is None else mesh.world
        if len(ranks) != world - 1:
            raise RuntimeError(
                f"checkpoint at {self.dir} was saved by {len(ranks) + 1} "
                f"rank(s); this run has {world}")
        if world > 1:
            sl = mesh.lanes(saved_env["pos"].shape[0])
            saved_env = {k: v[sl] for k, v in saved_env.items()}
            if saved_carry is not None:
                saved_carry = {k: v[sl] for k, v in saved_carry.items()}
            if mesh.rank > 0:
                gen_states = ranks[mesh.rank - 1]
        if saved_env["pos"].shape != template.env_state.pos.shape:
            raise RuntimeError(
                f"checkpoint at {self.dir} holds {saved_env['pos'].shape[0]} "
                f"lanes, this run {template.env_state.n}")
        for dst, key in ((count, "count"), (mu, "mu"), (nu, "nu")):
            dst.copy_(raw["opt_state"][key])
        dev = template.env_state.pos.device
        env_state = EnvState(**{k: v.to(dev) for k, v in saved_env.items()})
        gen = torch.Generator()
        gen.set_state(gen_states[0])
        noise = torch.Generator(device=dev)
        noise.set_state(gen_states[1])
        fields = dict(params=params, opt_state=(count, mu, nu),
                      env_state=env_state, last_obs=env_mod.observe(env_state),
                      generator=gen, update_idx=int(raw["update_idx"]),
                      noise_generator=noise)
        if not isinstance(template, RecurrentRunnerState):
            return RunnerState(**fields), step
        if saved_carry is None:
            raise RuntimeError(f"checkpoint at {self.dir} holds no LSTM carry "
                               f"(a feed-forward run?)")
        carry = tuple(saved_carry[k].to(dev) for k in ("c", "h"))
        if carry[0].shape != template.carry[0].shape:
            raise RuntimeError(f"checkpoint at {self.dir} holds a carry of "
                               f"shape {tuple(carry[0].shape)}, this run "
                               f"{tuple(template.carry[0].shape)}")
        return RecurrentRunnerState(**fields, carry=carry), step
