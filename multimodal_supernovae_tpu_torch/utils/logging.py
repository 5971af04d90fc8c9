"""Run metrics: ``metrics.jsonl`` and ``summary.json`` in the run directory,
and Weights & Biases when it is importable and asked for (port of
multimodal_supernovae_tpu/utils/logging.py).

``metrics.jsonl`` is opened for appending, so a resumed run adds its rows
after those of the run it continues; each row carries ``step`` (the epoch,
as the trainer passes it) and ``time`` (seconds since the epoch).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, run_dir: str, use_wandb: bool = False, wandb_kwargs=None):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb.init(**(wandb_kwargs or {}))
            except Exception:  # W&B is optional observability: run without it
                self._wandb = None
        self.summary: Dict[str, Any] = {}

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        row = {k: _to_py(v) for k, v in metrics.items()}
        if step is not None:
            row["step"] = step
        row["time"] = time.time()
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def set_summary(self, **kv) -> None:
        self.summary.update({k: _to_py(v) for k, v in kv.items()})
        with open(os.path.join(os.path.dirname(self.path), "summary.json"), "w") as f:
            json.dump(self.summary, f, indent=2)
        if self._wandb is not None:
            for k, v in kv.items():
                self._wandb.summary[k] = v

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


def _to_py(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return v
