"""Training metrics as JSON lines: ``<log_dir>/<name>/metrics.jsonl``, one
``{"step": epoch, ...}`` object an epoch, the file the JAX package's
``MetricsWriter`` writes (without its optional tensorboard mirror)."""

from __future__ import annotations

import json
import os
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str, name: str = "SAiD"):
        self.log_dir = os.path.join(log_dir, name)
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")

    def log(self, metrics: Dict[str, float], step: int) -> None:
        clean = {k: float(v) for k, v in metrics.items() if v is not None}
        self._jsonl.write(json.dumps({"step": step, **clean}) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
