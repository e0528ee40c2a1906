"""Fixed-length temporal segment pooling (counterpart of the JAX package's
``data/segments.py``, numpy only).

Training bags mean-pool each video's clip features into 32 linspace buckets
per crop: ``(n_clips, 10, 2048) -> (10, 32, 2048)``. Bucket edges are
``np.linspace(0, n, seg + 1, dtype=int)`` (truncation, as the reference);
an empty bucket copies the row at its left edge.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.npyio import atomic_save


def segment_features(features: np.ndarray, seg_length: int = 32) -> np.ndarray:
    """(n_clips, ncrops, C) -> (ncrops, seg_length, C) linspace mean pooling."""
    per_crop = features.transpose(1, 0, 2)  # (ncrops, n_clips, C)
    ncrops, n, c = per_crop.shape
    edges = np.linspace(0, n, seg_length + 1, dtype=int)
    out = np.zeros((ncrops, seg_length, c), dtype=np.float32)
    for i in range(seg_length):
        lo, hi = edges[i], edges[i + 1]
        if lo != hi:
            out[:, i, :] = per_crop[:, lo:hi, :].mean(axis=1)
        else:
            out[:, i, :] = per_crop[:, lo, :]
    return out


def segment_video_features(feature_path: str, seg_outpath: str, seg_length: int = 32,
                           overwrite: bool = False) -> int:
    """Segment every ``*.npy`` under ``feature_path`` into ``seg_outpath``,
    skipping files already there unless ``overwrite``; writes are atomic.
    Returns the number of files written."""
    os.makedirs(seg_outpath, exist_ok=True)
    written = 0
    for fname in sorted(os.listdir(feature_path)):
        if not fname.endswith(".npy"):
            continue
        savepath = os.path.join(seg_outpath, fname)
        if os.path.exists(savepath) and not overwrite:
            continue
        features = np.load(os.path.join(feature_path, fname))
        atomic_save(savepath, segment_features(features, seg_length))
        written += 1
    return written
