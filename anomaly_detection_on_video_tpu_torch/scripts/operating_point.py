"""Pick a deployment threshold from scored videos and a frame-level ground
truth (the port's counterpart of ``scripts/operating_point.py``).

Training reports threshold-free AUCs only; a deployed detector needs an
operating point. This joins the port's ``infer`` score JSONs
(``<stem>_scores.json``) with a ``ground_truth.json`` (``make_gt_ucf``) and
prints one JSON line, key for key the JAX script's:

- frame-level ROC AUC and PR AUC over every joined video;
- the best-F1 threshold (precision, recall and F1 at it);
- the threshold at a target false-positive rate (``--target-fpr``);
- ``--per-video``: each video's max frame score, for triage;
- ``--per-class``: the literature breakdown (per-class AUC against all
  normal videos, abnormal-subset AUC, FAR at 0.5 on normal videos;
  ``EvalResult.report``).

Host numpy only::

    python -m anomaly_detection_on_video_tpu_torch.scripts.operating_point \\
        --scores scores/ --gt ground_truth.json --target-fpr 0.01
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import List, Optional

import numpy as np

from ..ops.metrics import pr_auc, precision_recall_curve, roc_auc, roc_curve
from ..training.runner import EvalResult


def join_scores_with_gt(scores_dir: str, gt: dict):
    """Per-video (frame scores, frame labels) of the videos in both, and
    their concatenations."""
    videos = {}
    for path in sorted(glob.glob(os.path.join(scores_dir, "*_scores.json"))):
        with open(path) as f:
            rec = json.load(f)
        stem = os.path.basename(path)[: -len("_scores.json")]
        labels = gt.get(stem)
        if labels is None:  # GT keys may carry the _i3d suffix
            labels = gt.get(f"{stem}_i3d")
        if labels is None:
            continue
        frames = np.asarray(rec["frame_scores"], np.float64)
        labels = np.asarray(labels, np.float64)
        n = min(len(frames), len(labels))  # loop padding against annotation tails
        videos[stem] = (frames[:n], labels[:n])
    if not videos:
        raise SystemExit(f"no video in {scores_dir!r} matches a ground-truth key")
    scores = np.concatenate([s for s, _ in videos.values()])
    labels = np.concatenate([lab for _, lab in videos.values()])
    return scores, labels, videos


def operating_points(labels: np.ndarray, scores: np.ndarray, target_fpr: float = 0.01) -> dict:
    out = {
        "frames": int(labels.size),
        "positive_frames": int(labels.sum()),
        "roc_auc": round(roc_auc(labels, scores), 6),
        "pr_auc": round(pr_auc(labels, scores), 6),
    }

    precision, recall, thresholds = precision_recall_curve(labels, scores)
    # the curves carry the (recall 0, precision 1) end point past the last threshold
    p, r = precision[: len(thresholds)], recall[: len(thresholds)]
    f1 = np.where(p + r > 0, 2 * p * r / np.maximum(p + r, 1e-12), 0.0)
    best = int(np.argmax(f1))
    out["best_f1"] = {
        "threshold": float(thresholds[best]),
        "f1": round(float(f1[best]), 6),
        "precision": round(float(p[best]), 6),
        "recall": round(float(r[best]), 6),
    }

    fpr, tpr, roc_thresholds = roc_curve(labels, scores)
    fpr, tpr = fpr[1:], tpr[1:]  # drop the (0, 0) origin, which has no threshold
    ok = fpr <= target_fpr
    if ok.any():
        idx = int(np.argmax(np.where(ok, tpr, -1.0)))
        out["at_target_fpr"] = {
            "target_fpr": target_fpr,
            "threshold": float(roc_thresholds[idx]),
            "fpr": round(float(fpr[idx]), 6),
            "tpr": round(float(tpr[idx]), 6),
        }
    else:
        out["at_target_fpr"] = {"target_fpr": target_fpr, "threshold": None}
    return out


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--scores", required=True,
                        help="directory of the port's infer <stem>_scores.json files")
    parser.add_argument("--gt", required=True, help="ground_truth.json (make_gt_ucf)")
    parser.add_argument("--target-fpr", type=float, default=0.01)
    parser.add_argument("--per-video", action="store_true",
                        help="include per-video max frame scores")
    parser.add_argument("--per-class", action="store_true",
                        help="include the literature-standard breakdown (per-class AUC, "
                             "abnormal-subset AUC, FAR@0.5 on normal videos; EvalResult.report)")
    args = parser.parse_args(argv)
    if not os.path.exists(args.gt):
        parser.error(f"--gt {args.gt!r}: no such file")
    if not os.path.exists(args.scores):
        parser.error(f"--scores {args.scores!r}: no such file or directory")

    with open(args.gt) as f:
        gt = json.load(f)
    scores, labels, videos = join_scores_with_gt(args.scores, gt)
    out = operating_points(labels, scores, args.target_fpr)
    out["videos"] = len(videos)
    if args.per_video:
        out["per_video_max_score"] = {
            k: round(float(s.max()), 6) if s.size else 0.0 for k, (s, _) in sorted(videos.items())
        }
    if args.per_class:
        report = EvalResult(rec_auc=out["roc_auc"], pr_auc=out["pr_auc"], preds=scores,
                            labels=labels, videos=videos).report()
        out["far"] = report["far"]
        out["abnormal_auc"] = report["abnormal_auc"]
        out["per_class"] = report["per_class"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
