"""Metric loggers (counterpart of the JAX package's ``training/loggers.py``):
a JSONL history file and the console. Metric names are the reference's
(``train_loss``, ``lr-Adam``, ``valid/rec_auc``, ``valid/pr_auc``).
The W&B logger is not ported."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict


class JsonlLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        self._f.write(json.dumps({"step": step, "time": time.time(), **metrics}) + "\n")

    def close(self) -> None:
        self._f.close()


class ConsoleLogger:
    def __init__(self, every: int = 50, stream=None):
        self.every = every
        self.stream = stream or sys.stderr

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if "epoch" in metrics or step % self.every == 0:
            parts = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                             for k, v in metrics.items())
            print(f"[step {step}] {parts}", file=self.stream)
