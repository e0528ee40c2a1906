"""Frame-level ROC-AUC and PR-AUC (numpy, sklearn semantics), and the
thresholded event windows that serving reports.

Counterpart of the JAX package's ``ops/metrics.py``: clip scores repeat x16
to frame level; ROC uses thresholds at distinct scores, trapezoidal AUC; the
PR curve appends the (recall 0, precision 1) endpoint and its area is
trapezoidal auc(recall, precision) as the reference computes it, which is
not average precision.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _binary_curve(labels: np.ndarray, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cumulative TP/FP counts at each distinct score threshold (desc)."""
    labels = np.asarray(labels, dtype=np.float64).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    order = np.argsort(-scores, kind="mergesort")
    scores, labels = scores[order], labels[order]
    distinct = np.where(np.diff(scores))[0]
    threshold_idx = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels)[threshold_idx]
    fps = 1 + threshold_idx - tps
    return tps, fps, scores[threshold_idx]


def roc_curve(labels: np.ndarray, scores: np.ndarray):
    """sklearn.metrics.roc_curve semantics, with the (0, 0) origin."""
    tps, fps, thresholds = _binary_curve(labels, scores)
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    tpr = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    fpr = fps / fps[-1] if fps[-1] > 0 else np.zeros_like(fps)
    return fpr, tpr, thresholds


def precision_recall_curve(labels: np.ndarray, scores: np.ndarray):
    """sklearn.metrics.precision_recall_curve semantics: increasing
    threshold, (recall 0, precision 1) endpoint last."""
    tps, fps, thresholds = _binary_curve(labels, scores)
    denom = tps + fps
    precision = np.where(denom > 0, tps / np.maximum(denom, 1), 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (
        np.r_[precision[::-1], 1.0],
        np.r_[recall[::-1], 0.0],
        thresholds[::-1],
    )


def auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area, sklearn.metrics.auc semantics (x monotonic)."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    dx = np.diff(x)
    if dx.size == 0:
        raise ValueError("at least 2 points are required to compute AUC")
    direction = 1.0
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1.0
        else:
            raise ValueError("x is neither increasing nor decreasing")
    # numpy >= 2 renamed trapz to trapezoid
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return float(direction * trapezoid(y, x))


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    fpr, tpr, _ = roc_curve(labels, scores)
    return auc(fpr, tpr)


def pr_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """The reference's PR-AUC: trapezoidal auc(recall, precision)."""
    precision, recall, _ = precision_recall_curve(labels, scores)
    return auc(recall, precision)


def false_alarm_rate(labels: np.ndarray, scores: np.ndarray, threshold: float = 0.5) -> float:
    """Fraction of negative frames scored above ``threshold``, FP / (FP +
    TN); NaN without negative frames. The literature computes it over the
    normal test videos (``EvalResult.false_alarm_rate``)."""
    labels = np.asarray(labels, dtype=np.float64).ravel()
    scores = np.asarray(scores, dtype=np.float64).ravel()
    negative = labels == 0
    if not negative.any():
        return float("nan")
    return float(np.mean(scores[negative] > threshold))


def frame_level_scores(clip_scores: np.ndarray, frames_per_clip: int = 16) -> np.ndarray:
    """Repeat per-clip scores to frame level."""
    return np.repeat(np.asarray(clip_scores).ravel(), frames_per_clip)


def anomaly_events(frame_scores: np.ndarray, threshold: float, min_frames: int = 1) -> list:
    """Contiguous frame runs scoring above ``threshold`` -> event windows,
    the inverse of the ground-truth builder's window -> frame labels. Per
    event: inclusive ``start_frame`` / ``end_frame`` (the UCF-Crime
    annotation convention), ``frames``, and the window's ``peak`` and
    ``mean`` score rounded to 6 decimals; runs shorter than ``min_frames``
    are dropped (debounce)."""
    scores = np.asarray(frame_scores, dtype=np.float64).ravel()
    above = scores > threshold
    edges = np.flatnonzero(np.diff(np.r_[0, above.astype(np.int8), 0]))
    events = []
    for start, end in zip(edges[::2], edges[1::2]):  # end exclusive here
        if end - start < min_frames:
            continue
        window = scores[start:end]
        events.append({
            "start_frame": int(start),
            "end_frame": int(end - 1),
            "frames": int(end - start),
            "peak": round(float(window.max()), 6),
            "mean": round(float(window.mean()), 6),
        })
    return events
