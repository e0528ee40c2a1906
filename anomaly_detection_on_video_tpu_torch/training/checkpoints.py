"""Top-k checkpointing (counterpart of the JAX package's
``training/checkpoints.py`` ``TopKCheckpointer``), saved with ``torch.save``.

A save writes ``<dir>/<step>/state.pt`` (model state dict, optimizer state
dict, step) and, when the save carries a metric, ``<dir>/<step>/
metrics.json``; a step directory is complete once renamed into place.
Retention is the JAX checkpointer's orbax policy: the latest step, plus
the ``top_k`` steps with the highest metric (every step while there are at
most ``top_k``); a metric-less save (preemption, an epoch without eval) is
kept only while it is the latest. ``hparams.json`` holds the run's
hyperparameters with the JAX checkpointer's keys. The JAX package's orbax
checkpoints do not load here.

In a multi-process run every rank opens the directory and reads it; only
rank 0 (``parallel.process_index``) writes, and every rank calls ``save``,
which assembles a DP x TP state into the single-device layout first, so a
checkpoint resumes at any ``tensor_parallel`` and serves through ``infer``.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from ..parallel import process_index

METADATA_FILE = "hparams.json"
STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"


class TopKCheckpointer:
    def __init__(self, directory: str, top_k: int = 10):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.top_k = top_k

    def all_steps(self) -> List[int]:
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(
                          os.path.join(self.directory, name, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> Optional[Dict[str, float]]:
        path = os.path.join(self.directory, str(step), METRICS_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save(self, step: int, state: Any, metric: Optional[float] = None) -> Optional[str]:
        """Save ``state`` (a ``TrainState``) as ``step``; returns the step
        directory (None on ranks other than 0, which write nothing). A step
        already on disk (a run resumed from an earlier step) is replaced.
        Every rank of a DP x TP run must call it: the state's slices are
        gathered."""
        model_sd, optimizer_sd = state.state_dicts()
        if process_index() != 0:
            return None
        path = os.path.join(self.directory, str(step))
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save({"model": model_sd, "optimizer": optimizer_sd, "step": int(state.step)},
                   os.path.join(tmp, STATE_FILE))
        if metric is not None:
            with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                json.dump({"metric": float(metric)}, f)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        self._prune()
        return path

    def _prune(self) -> None:
        """Delete what the retention policy does not keep: orbax's
        ``LatestN(1)`` or ``BestN(n=top_k, keep_checkpoints_without_metrics=
        False)``, whose ascending stable sort keeps the newer of equal
        metrics."""
        steps = self.all_steps()
        if len(steps) <= self.top_k:
            return
        keep = {steps[-1]}
        ranked = [(self.metrics(s), s) for s in steps]
        ranked = sorted([(m["metric"], s) for m, s in ranked if m is not None],
                        key=lambda item: item[0])
        if self.top_k > 0:
            keep.update(s for _, s in ranked[-self.top_k:])
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, str(s)))

    def resolve_step(self, selector: Any = "latest") -> Optional[int]:
        """``"latest"`` / None -> the newest step; ``"best"`` -> the step
        with the highest metric (ties toward the newer step; the newest
        when no save carried one); an int or digit string -> that step,
        raising ValueError with the saved steps when it is absent. None
        when nothing is saved."""
        if selector is None or isinstance(selector, bool) or selector == "latest":
            return self.latest_step()
        if selector == "best":
            best_step, best_metric = None, None
            for s in self.all_steps():
                m = self.metrics(s) or {}
                if "metric" not in m:
                    continue
                v = float(m["metric"])
                if best_metric is None or v >= best_metric:
                    best_step, best_metric = s, v
            return best_step if best_step is not None else self.latest_step()
        step = int(selector)
        if step not in self.all_steps():
            raise ValueError(f"checkpoint step {step} not found in {self.directory}; "
                             f"available steps: {self.all_steps()}")
        return step

    def restore(self, state: Any, step: Any = "latest") -> Any:
        """Load a saved step (a ``resolve_step`` selector) into ``state``'s
        model and optimizer and set its step; ``state`` unchanged when the
        directory holds no checkpoint."""
        step = self.resolve_step(step)
        if step is None:
            return state
        device = next(state.model.parameters()).device
        payload = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                             map_location=device, weights_only=True)
        try:
            state.load_state_dicts(payload["model"], payload["optimizer"])
        except (RuntimeError, ValueError, KeyError) as exc:
            raise ValueError(
                f"could not restore checkpoint step {step} from {self.directory}: the saved "
                f"state does not match the model or optimizer, typically because the model "
                f"config differs from the run that wrote it (see {METADATA_FILE})") from exc
        state.step = int(payload["step"])
        return state

    def write_metadata(self, metadata: Dict[str, Any]) -> Optional[str]:
        """Atomically write the run's hyperparameters to hparams.json (rank
        0 only)."""
        if process_index() != 0:
            return None
        path = os.path.join(self.directory, METADATA_FILE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(metadata, f, indent=2, default=str)
        os.replace(tmp, path)
        return path

    @staticmethod
    def load_metadata(directory: str) -> Optional[Dict[str, Any]]:
        path = os.path.join(os.path.abspath(directory), METADATA_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)
