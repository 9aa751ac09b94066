"""Structured metrics: JSONL writer + console dashboard line + optional
TensorBoard.

Counterpart of `drone_tpu/utils/metrics.py`, with the same record format
and metric names (SPS, ep_return_mean, ep_length_mean, losses), so curves
from the two packages compare directly. JSONL is the durable format;
TensorBoard event files are written too when a tb_dir is given and
torch.utils.tensorboard can be imported. `RichDashboard` falls back to
plain lines when `rich` is missing.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


def _make_tb_writer(tb_dir):
    try:  # pragma: no cover - depends on installed extras
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=str(tb_dir))
    except ImportError:
        return None


class MetricsLogger:
    def __init__(self, path: str | Path | None = None,
                 tb_dir: str | Path | None = None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
        else:
            self._f = None
        self._tb = _make_tb_writer(tb_dir) if tb_dir else None
        self.t0 = time.time()

    def log(self, step: int, metrics: dict, sps: float | None = None) -> dict:
        rec = {
            "ts": round(time.time() - self.t0, 3),
            "global_step": int(step),
            **{k: (float(v) if hasattr(v, "__float__") else v)
               for k, v in metrics.items()},
        }
        if sps is not None:
            rec["SPS"] = round(float(sps), 1)
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
        if self._tb:
            for k, v in rec.items():
                if k not in ("ts", "global_step") and isinstance(v, float):
                    self._tb.add_scalar(k, v, global_step=int(step))
        return rec

    def close(self):
        if self._f:
            self._f.close()
        if self._tb:
            self._tb.close()


class RichDashboard:
    """Live-updating console dashboard (the reference trainer's rich
    dashboard, SURVEY.md §5 tracing note). Falls back to plain lines when
    rich isn't importable. Enable with run.dashboard='rich'."""

    FIELDS = ("SPS", "ep_return_mean", "ep_length_mean", "reward_mean",
              "loss", "pg_loss", "v_loss", "entropy", "approx_kl", "clipfrac",
              "episodes")

    def __init__(self, total_updates: int):
        self.total = total_updates
        try:
            from rich.live import Live
            from rich.table import Table
        except ImportError:  # pragma: no cover
            self._live = None
            return
        self._Table = Table
        self._live = Live(auto_refresh=False)
        self._live.start()

    def update(self, u: int, rec: dict):
        if self._live is None:
            print(dashboard_line(u, self.total, rec), flush=True)
            return
        t = self._Table(title=f"drone_tpu_torch train — update {u}/{self.total}")
        t.add_column("metric")
        t.add_column("value", justify="right")
        for k in self.FIELDS:
            if k in rec:
                v = rec[k]
                t.add_row(k, f"{v:,.4g}" if isinstance(v, float) else str(v))
        self._live.update(t, refresh=True)

    def close(self):
        if self._live is not None:
            self._live.stop()


def dashboard_line(update: int, total: int, rec: dict) -> str:
    """One human-readable console line per log interval (the reference's
    rich dashboard, reduced to what matters)."""
    parts = [f"upd {update}/{total}"]
    for k, fmt in (
        ("SPS", "sps {:.2e}"),
        ("ep_return_mean", "ret {:8.2f}"),
        ("ep_length_mean", "len {:6.1f}"),
        ("reward_mean", "rew {:7.3f}"),
        ("loss", "loss {:7.3f}"),
        ("approx_kl", "kl {:.4f}"),
    ):
        if k in rec:
            parts.append(fmt.format(rec[k]) if "{" in fmt else f"{k} {rec[k]}")
    return "  ".join(parts)
