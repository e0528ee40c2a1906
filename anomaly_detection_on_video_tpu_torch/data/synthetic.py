"""Structured synthetic MIL bags: training-quality evidence without data
(counterpart of the JAX package's ``data/synthetic.py``, numpy only, so a
seed gives the same arrays bit for bit in both packages).

Anomalous videos hold a contiguous window of segments whose features have
elevated magnitude (the signal MGFN's magnitude channel and RTFM's
feature-magnitude top-k key on), in the same background distribution as
normal videos.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from .features import FeatureDataset


def _base(rng: np.random.RandomState, shape, dim: int) -> np.ndarray:
    """Background features: anisotropic gaussians, unit-ish magnitude."""
    scale = 1.0 + 0.5 * rng.rand(dim).astype(np.float32)  # per-channel spread
    return (rng.randn(*shape, dim) * scale / np.sqrt(dim)).astype(np.float32)


def _elevate(rng: np.random.RandomState, bag: np.ndarray, strength: float,
             min_frac: float = 0.15, max_frac: float = 0.5) -> np.ndarray:
    """Scale a random contiguous segment window by ``strength`` (all
    crops); returns the boolean per-segment anomaly mask."""
    t = bag.shape[-2]
    width = max(1, int(t * (min_frac + (max_frac - min_frac) * rng.rand())))
    start = rng.randint(0, t - width + 1)
    bag[..., start: start + width, :] *= strength
    mask = np.zeros((t,), bool)
    mask[start: start + width] = True
    return mask


def make_synthetic_train(seed: int, n_videos: int = 32, t: int = 32, dim: int = 64,
                         strength: float = 1.3) -> Tuple[FeatureDataset, FeatureDataset]:
    """(normal, abnormal) train datasets of ``(10, t, dim)`` segment bags."""
    rng = np.random.RandomState(seed)
    normal, abnormal = {}, {}
    for i in range(n_videos):
        normal[f"Normal_{i}_i3d.npy"] = _base(rng, (10, t), dim)
        bag = _base(rng, (10, t), dim)
        _elevate(rng, bag, strength)
        abnormal[f"Abuse_{i}_i3d.npy"] = bag
    return (FeatureDataset(filenames=sorted(normal), _arrays=normal),
            FeatureDataset(filenames=sorted(abnormal), _arrays=abnormal))


def write_synthetic_dataset(outdir: str, seed: int = 0, t: int = 32, dim: int = 64,
                            strength: float = 1.3, frames_per_clip: int = 16):
    """Write the bags as the reference's on-disk files: train segment bags
    ``(10, t, dim)`` in ``segments/``, test clip features ``(n_clips, 10,
    dim)`` in ``test/`` (``<name>_i3d.npy``), and ``ground_truth.json`` of
    frame-label lists, the contract the training entry reads.

    Returns ``(train_dir, test_dir, gt_path)``.
    """
    normal, abnormal = make_synthetic_train(seed, t=t, dim=dim, strength=strength)
    eval_ds = make_synthetic_eval(seed, dim=dim, strength=strength,
                                  frames_per_clip=frames_per_clip)
    train_dir = os.path.join(outdir, "segments")
    test_dir = os.path.join(outdir, "test")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(test_dir, exist_ok=True)
    for ds in (normal, abnormal):
        for name, bag in ds._arrays.items():
            np.save(os.path.join(train_dir, name), bag)
    gt = {}
    for name in eval_ds.filenames:
        np.save(os.path.join(test_dir, name), eval_ds._arrays[name])
        gt[name[: -len("_i3d.npy")]] = eval_ds.labels[name]
    gt_path = os.path.join(outdir, "ground_truth.json")
    with open(gt_path, "w") as f:
        json.dump(gt, f)
    return train_dir, test_dir, gt_path


def make_synthetic_eval(seed: int, n_videos: int = 16, dim: int = 64, strength: float = 1.3,
                        frames_per_clip: int = 16) -> FeatureDataset:
    """Test split: ``(n_clips, 10, dim)`` clip features and frame GT lists.

    Half the videos are normal (all-zero GT); the other half carry one
    elevated window whose clips are labeled anomalous (``frames_per_clip``
    frames each, the frame-level protocol).
    """
    rng = np.random.RandomState(seed + 7919)
    filenames, arrays, labels = [], {}, {}
    for i in range(n_videos):
        n_clips = int(rng.randint(24, 49))
        clips = _base(rng, (10, n_clips), dim)  # (10, n_clips, dim)
        if i % 2 == 0:
            name = f"Normal_eval_{i}_i3d.npy"
            mask = np.zeros((n_clips,), bool)
        else:
            name = f"Abuse_eval_{i}_i3d.npy"
            mask = _elevate(rng, clips, strength)
        arrays[name] = np.swapaxes(clips, 0, 1).copy()  # (n_clips, 10, dim)
        labels[name] = np.repeat(mask.astype(np.float32), frames_per_clip).tolist()
        filenames.append(name)
    return FeatureDataset(filenames=filenames, _arrays=arrays, labels=labels)
