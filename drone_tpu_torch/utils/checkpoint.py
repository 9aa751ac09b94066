"""Policy checkpoints in the port's own format: `torch.save` of
{"params": state_dict} at `<dir>/<step>/params.pt`.

Counterpart of `drone_tpu/utils/checkpoint.py` for what evaluation needs
(the policy parameters). The training slice extends it with optimizer and
runner state.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn

_FILE = "params.pt"


class Checkpointer:
    """Restore paths create nothing: a caller with a wrong directory gets
    FileNotFoundError, not an empty run directory on disk."""

    def __init__(self, directory: str | Path):
        self.dir = Path(directory).resolve()

    def save(self, step: int, params) -> Path:
        """Save an nn.Module's or a state dict's tensors as step `step`."""
        if isinstance(params, nn.Module):
            params = params.state_dict()
        path = self.dir / str(int(step)) / _FILE
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        torch.save({"params": {k: v.detach().cpu() for k, v in params.items()}},
                   tmp)
        tmp.replace(path)
        return path

    def latest_step(self) -> int | None:
        if not self.dir.is_dir():
            return None
        steps = [int(d.name) for d in self.dir.iterdir()
                 if d.name.isdigit() and (d / _FILE).is_file()]
        return max(steps) if steps else None

    def restore_raw(self, step: int | None = None):
        """({"params": state_dict of CPU tensors}, step) of `step` or the
        latest one."""
        if not self.dir.is_dir():
            raise FileNotFoundError(f"no checkpoint directory {self.dir}")
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.dir}")
        raw = torch.load(self.dir / str(int(step)) / _FILE, map_location="cpu",
                         weights_only=True)
        return raw, step
