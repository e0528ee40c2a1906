"""Ahead-of-time scorer export (counterpart of the JAX package's
``utils/aot.py``): export once, serve without the model code.

``torch.export`` captures the scoring step ``scorer(feature,
length=length)`` with its weights, one program per eval bucket (the
power-of-two clip padding of ``training/runner.eval_bucket``), and
``torch.export.save`` writes each as ``scorer_b{bucket}.pt2`` beside a
``manifest.json``. A serving process loads them with ``ExportedScorer``
and scores without the checkpoint, the model's Python code or a rebuild of
the model. Consumed by ``infer --export DIR`` / ``infer --from-export DIR``.

A program holds the tensors of the device it was exported on; loading it on
another device moves them (``torch.export.passes.move_to_device_pass``).
The live scorer runs in full float32 with TF32 off (``make_eval_step``);
those flags are process state that an exported program does not carry, so
``ExportedScorer.score`` sets them around every call, and its scores equal
the live scorer's. A program is tied to the torch version that wrote it:
another version is refused with a line that says to re-export.
"""

from __future__ import annotations

import io
import json
import os
from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

from ..data.features import pad_eval_batch
from ..training.runner import buckets_up_to
from .device import DeviceLike, full_f32, resolve_device
from .npyio import atomic_write_bytes

MANIFEST_NAME = "manifest.json"
FORMAT = "anomaly_detection_on_video_tpu_torch.scorer_export.v1"
_ARTIFACT_FMT = "scorer_b{bucket}.pt2"

# every eval bucket a video of at most max_clips clips can hit
export_buckets = buckets_up_to


def artifact_path(directory: str, bucket: int) -> str:
    """The file of one bucket's program in an export directory."""
    return os.path.join(directory, _ARTIFACT_FMT.format(bucket=bucket))


class _ScoringStep(nn.Module):
    """``make_eval_step``'s call as a module with positional inputs, the
    form ``torch.export`` captures."""

    def __init__(self, scorer: nn.Module):
        super().__init__()
        self.scorer = scorer

    def forward(self, feature: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        return self.scorer(feature, length=length)


def export_scorer(scorer: nn.Module, *, channels: int = 2048, n_crops: int = 10,
                  buckets: Sequence[int] = (32, 64, 128, 256),
                  device: DeviceLike = "cuda") -> Dict[int, torch.export.ExportedProgram]:
    """One ``torch.export`` program per bucket of the eval-mode ``scorer``
    (on ``device``), on ``(1, n_crops, bucket, channels + 1)`` float32
    features and a ``(1,)`` int64 length; ``channels`` is the feature width
    before the magnitude channel (2048, 4096 two-stream)."""
    device = resolve_device(device)
    step = _ScoringStep(scorer.eval())
    exported = {}
    for bucket in sorted(set(int(b) for b in buckets)):
        feature = torch.zeros((1, n_crops, bucket, channels + 1), dtype=torch.float32,
                              device=device)
        length = torch.tensor([bucket], dtype=torch.int64, device=device)
        exported[bucket] = torch.export.export(step, (feature, length))
    return exported


def save_scorer_export(outdir: str, exported: Dict[int, torch.export.ExportedProgram], *,
                       model_name: str, channels: int = 2048, n_crops: int = 10,
                       stream: str = "rgb", device: DeviceLike = "cuda") -> str:
    """Write each program as ``scorer_b{bucket}.pt2`` and the manifest
    (the JAX manifest's keys, ``device`` and ``torch_version`` in place of
    ``platforms`` and ``jax_version``), atomically; returns the manifest's
    path."""
    os.makedirs(outdir, exist_ok=True)
    for bucket, program in exported.items():
        buf = io.BytesIO()
        torch.export.save(program, buf)
        atomic_write_bytes(artifact_path(outdir, bucket), buf.getvalue())
    manifest = {
        "format": FORMAT,
        "model_name": model_name,
        "channels": channels,
        "n_crops": n_crops,
        "stream": stream,
        "buckets": sorted(exported),
        "device": torch.device(device).type,
        "torch_version": torch.__version__,
    }
    path = os.path.join(outdir, MANIFEST_NAME)
    atomic_write_bytes(path, json.dumps(manifest, indent=1).encode())
    return path


class ExportedScorer:
    """Scores features through the exported programs of ``directory`` on
    ``device``, with no model code.

    ``score`` takes what ``infer.score_features`` takes, ``(n_clips,
    n_crops, channels)`` float32, and pads it the same way into the
    smallest exported bucket that holds it."""

    def __init__(self, directory: str, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        manifest_path = os.path.join(directory, MANIFEST_NAME)
        if not os.path.isfile(manifest_path):
            raise FileNotFoundError(f"{directory!r} is not a scorer export (no {MANIFEST_NAME}; "
                                    "create one with infer --export)")
        with open(manifest_path) as f:
            try:
                self.manifest = json.load(f)
            except json.JSONDecodeError as exc:
                raise ValueError(f"corrupt manifest {manifest_path!r}: {exc}") from exc
        fmt = self.manifest.get("format")
        if fmt != FORMAT:
            raise ValueError(f"{directory!r} holds a {fmt!r} export, not the port's ({FORMAT}); "
                             "re-export the scorer with the port's infer --export")
        version = self.manifest.get("torch_version")
        if version != torch.__version__:
            raise ValueError(f"{directory!r} was exported with torch {version} and this is torch "
                             f"{torch.__version__}; re-export the scorer with this torch's "
                             "infer --export")
        self.model_name = self.manifest.get("model_name", "unknown")
        self.channels = int(self.manifest.get("channels", 2048))
        self.n_crops = int(self.manifest.get("n_crops", 10))
        self.stream = self.manifest.get("stream", "rgb")
        self._programs = {}
        for bucket in self.manifest.get("buckets", []):
            path = artifact_path(directory, bucket)
            if not os.path.isfile(path):
                raise FileNotFoundError(f"scorer export {directory!r} is missing the bucket-"
                                        f"{bucket} artifact named by its manifest ({path})")
            program = torch.export.load(path)
            if self.manifest.get("device") != self.device.type:
                from torch.export.passes import move_to_device_pass

                program = move_to_device_pass(program, self.device)
            self._programs[int(bucket)] = program.module()
        if not self._programs:
            raise ValueError(f"scorer export {directory!r} has no bucket artifacts")
        self.buckets = sorted(self._programs)

    def score(self, features: np.ndarray) -> np.ndarray:
        """(n_clips, n_crops, channels) float32 -> (n_clips,) clip scores."""
        features = np.asarray(features, np.float32)
        n_clips, n_crops = features.shape[:2]
        if n_crops != self.n_crops:
            raise ValueError(f"this export was built for {self.n_crops} crops per clip, got "
                             f"{n_crops} (re-export with the matching --crops)")
        if features.shape[-1] != self.channels:
            raise ValueError(f"this export scores {self.channels}-d features, got "
                             f"{features.shape[-1]}-d (re-export for this stream mode)")
        bucket = next((b for b in self.buckets if b >= n_clips), None)
        if bucket is None:
            raise ValueError(f"video has {n_clips} clips but the largest exported bucket is "
                             f"{self.buckets[-1]}; re-export with a larger --export-max-clips")
        feats = torch.from_numpy(pad_eval_batch(features, bucket)).to(self.device)
        length = torch.tensor([n_clips], dtype=torch.int64, device=self.device)
        # grad mode is per thread (serving calls come from handler threads);
        # TF32 is process state the program does not carry
        with torch.no_grad(), full_f32():
            scores = self._programs[bucket](feats, length)
        return scores[0, :n_clips, 0].cpu().numpy()
