"""Metric loggers (counterpart of the JAX package's ``training/loggers.py``):
a JSONL history file, the console, and W&B where ``wandb`` is installed
(imported only when a ``WandbLogger`` is made). Metric names are the
reference's (``train_loss``, ``lr-Adam``, ``valid/rec_auc``,
``valid/pr_auc``)."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


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


class WandbLogger:
    """Scalars, eval figures (``wandb.Image``) and, with ``log_model``,
    checkpoint directories as artifacts to a W&B run, as the reference's
    Lightning ``WandbLogger`` logs them. Without ``wandb`` it warns once and
    logs nothing."""

    def __init__(self, project: str = "anomaly-detection-on-video-tpu",
                 name: Optional[str] = None, key: Optional[str] = None,
                 log_model: bool = False):
        self.log_model = log_model
        try:
            import wandb
        except ImportError:
            # wandb_key asked for W&B: a silent no-op would look like a lost run
            print("warning: wandb_key is set but the wandb package is not installed; W&B logging "
                  "disabled (JSONL/console logging unaffected)", file=sys.stderr)
            self._run = None
            self._wandb = None
            return
        self._wandb = wandb
        if key:
            wandb.login(key=key)
        self._run = wandb.init(project=project, name=name)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if self._run is not None:
            self._run.log(metrics, step=step)

    def log_image(self, name: str, path: str, step: int) -> None:
        if self._run is not None:
            self._run.log({name: self._wandb.Image(path)}, step=step)

    def log_artifact(self, path: str, name: str, type: str = "model") -> None:
        """Upload a checkpoint directory (or file) as an artifact."""
        if self._run is None or not self.log_model:
            return
        artifact = self._wandb.Artifact(name, type=type)
        if os.path.isdir(path):
            artifact.add_dir(path)
        else:
            artifact.add_file(path)
        self._run.log_artifact(artifact)
