"""Top-k checkpointing (counterpart of the JAX package's
``training/checkpoints.py`` ``TopKCheckpointer``), saved in orbax's format.

A save writes ``<dir>/<step>/`` as the JAX checkpointer's orbax
``StandardSave`` does (``training/orbax.write_orbax_step`` of
``utils/convert.train_state_to_orbax``: params, batch_stats, the Adam
state, step; ``metrics/metrics`` when the save carries a metric), into
``<step>.tmp`` first; a step directory is complete once renamed into
place. So a run trained here resumes in the JAX package's ``run.py``, and
serves in its ``infer.py --checkpoint`` and ``eval_only``. ``hparams.json``
holds the run's hyperparameters with the JAX checkpointer's keys.

A directory may also hold steps of the port's earlier format, ``<step>/
state.pt`` (``torch.save`` of the model and optimizer state dicts and the
step) and ``<step>/metrics.json``: ``all_steps``, ``metrics``,
``resolve_step``, retention and ``restore`` take both formats alike (an
orbax step's metric is its ``metrics/metrics``), and ``restore`` reads an
orbax step through ``training/orbax.py`` and ``utils/convert.
train_state_from_orbax`` (weights, Adam moments, step), whether the port
or a TPU job wrote it.
Retention is the JAX checkpointer's orbax policy over every step, whatever
its format: the latest step, plus the ``top_k`` steps with the highest
metric (every step while there are at most ``top_k``); a metric-less save
(preemption, an epoch without eval) is kept only while it is the latest.
A step is replaced only when that same step is saved again (a run resumed
from an earlier step), as the JAX ``save`` replaces it.

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

from ..models import MODEL_REGISTRY
from ..parallel import process_index
from ..utils.convert import train_state_from_orbax, train_state_to_orbax
from .orbax import is_orbax_step, read_orbax_metrics, read_orbax_step, write_orbax_step

METADATA_FILE = "hparams.json"
STATE_FILE = "state.pt"  # a step of the port's earlier format
METRICS_FILE = "metrics.json"


def model_family(model: Any) -> str:
    """The registry name (``mgfn``, ``rtfm``, ``sultani``) of a scorer's
    class; ValueError for any other model."""
    name = next((n for n, (_, cls) in MODEL_REGISTRY.items() if isinstance(model, cls)), None)
    if name is None:
        raise ValueError(f"{type(model).__name__} is not a scorer of {sorted(MODEL_REGISTRY)}")
    return name


class TopKCheckpointer:
    def __init__(self, directory: str, top_k: int = 10):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.top_k = top_k

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def is_orbax(self, step: int) -> bool:
        """Whether saved ``step`` is a JAX (orbax) step."""
        return not os.path.exists(os.path.join(self._path(step), STATE_FILE)) and is_orbax_step(
            self._path(step))

    def all_steps(self) -> List[int]:
        """The saved steps, the port's and orbax's alike."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and (
                          os.path.exists(os.path.join(self.directory, name, STATE_FILE))
                          or is_orbax_step(os.path.join(self.directory, name))))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step: int) -> Optional[Dict[str, float]]:
        if self.is_orbax(step):
            return read_orbax_metrics(self._path(step))
        path = os.path.join(self.directory, str(step), METRICS_FILE)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def save(self, step: int, state: Any, metric: Optional[float] = None) -> Optional[str]:
        """Save ``state`` (a ``TrainState`` of a registered scorer) as
        orbax step ``step``; returns the step directory (None on ranks
        other than 0, which write nothing). A step already on disk, of
        either format (a run resumed from an earlier step), is replaced.
        Every rank of a DP x TP run must call it: the state's slices are
        gathered."""
        state_dicts = state.state_dicts()
        if process_index() != 0:
            return None
        tree = train_state_to_orbax(state, model_family(state.model), state_dicts)
        path = self._path(step)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        write_orbax_step(tmp, tree, metric)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        self._prune()
        return path

    def _prune(self) -> None:
        """Delete what the retention policy does not keep, over the steps
        of both formats: orbax's ``LatestN(1)`` or ``BestN(n=top_k,
        keep_checkpoints_without_metrics=False)``, whose ascending stable
        sort keeps the newer of equal metrics."""
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
        directory holds no checkpoint. An orbax step loads its params,
        batch_stats, Adam moments and step (the family is the model's
        class)."""
        step = self.resolve_step(step)
        if step is None:
            return state
        if self.is_orbax(step):
            return self._restore_orbax(state, step)
        device = next(state.model.parameters()).device
        payload = torch.load(os.path.join(self.directory, str(step), STATE_FILE),
                             map_location=device, weights_only=True)
        try:
            state.load_state_dicts(payload["model"], payload["optimizer"])
        except (RuntimeError, ValueError, KeyError) as exc:
            raise self._mismatch(step) from exc
        state.step = int(payload["step"])
        return state

    def _mismatch(self, step: int) -> ValueError:
        return ValueError(
            f"could not restore checkpoint step {step} from {self.directory}: the saved "
            f"state does not match the model or optimizer, typically because the model "
            f"config differs from the run that wrote it (see {METADATA_FILE})")

    def _restore_orbax(self, state: Any, step: int) -> Any:
        try:
            tree = read_orbax_step(self._path(step))
        except (OSError, ValueError, KeyError) as exc:
            raise ValueError(
                f"could not read orbax checkpoint step {step} from {self.directory}: {exc}. "
                "Export its weights with the JAX package's utils/convert.py "
                "export_{mgfn,rtfm,sultani}_state_dict and pass them as --torch-weights"
            ) from exc
        try:
            name = model_family(state.model)
        except ValueError as exc:
            raise ValueError(f"orbax step {step}: {exc}") from None
        try:
            return train_state_from_orbax(tree, name, state)
        except (RuntimeError, ValueError, KeyError, TypeError) as exc:
            raise self._mismatch(step) from exc

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
