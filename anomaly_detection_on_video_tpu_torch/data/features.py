"""The eval feature layout (counterpart of the JAX package's
``data/features.py`` ``add_magnitude`` and ``pad_eval_batch``)."""

from __future__ import annotations

import numpy as np


def add_magnitude(feature: np.ndarray) -> np.ndarray:
    """Append the L2 feature magnitude channel: (..., T, 2048) -> 2049."""
    magnitude = np.linalg.norm(feature, axis=-1, keepdims=True)
    return np.concatenate([feature, magnitude], axis=-1)


def pad_eval_batch(features: np.ndarray, bucket: int) -> np.ndarray:
    """(n_clips, n_crops, C) f32 features -> one (1, n_crops, bucket, C+1)
    eval batch: magnitude appended, crop axis first, clip axis zero-padded
    to ``bucket`` (masked by the scorer's ``length``)."""
    n_clips, n_crops = features.shape[:2]
    out = np.zeros((1, n_crops, bucket, features.shape[-1] + 1), np.float32)
    out[0, :, :n_clips] = add_magnitude(features).transpose(1, 0, 2)
    return out
