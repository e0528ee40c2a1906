"""Frame-level ground truth from the UCF-Crime temporal annotations
(counterpart of the JAX package's ``data/gt.py``).

Each test video gets ``n_clips * frames_per_clip`` frame labels; frames
inside up to two annotated event windows are 1.0, the end index inclusive
and clamped. An event counts when its start and end are both positive (the
JAX package's reading of the reference's duplicated start check).
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Dict, Iterable, List, Tuple

import numpy as np

Event = Tuple[int, int]


def parse_temporal_annotations(path: str) -> Dict[str, Dict[str, Event]]:
    """``Temporal_Anomaly_Annotation_for_Testing_Videos.txt``: lines of
    filename, class, s1, e1, s2, e2 separated by two spaces; keyed by the
    filename's stem."""
    annots: Dict[str, Dict[str, Event]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            filename, _, s1, e1, s2, e2 = line.split("  ")
            s1, e1, s2, e2 = map(int, (s1, e1, s2, e2))
            annots[filename.split(".")[0]] = {"first_event": (s1, e1), "second_event": (s2, e2)}
    return annots


def frame_labels(events: Iterable[Event], num_frame: int) -> List[float]:
    """Frame-level 0/1 labels over ``num_frame`` frames for event windows."""
    gt = [0.0] * num_frame
    for start, end in events:
        if start > 0 and end > 0:
            for i in range(start, min(end + 1, num_frame)):
                gt[i] = 1.0
    return gt


def build_ground_truth(annotations_path: str, test_features_path: str,
                       frames_per_clip: int = 16) -> Dict[str, List[float]]:
    """``ground_truth.json``'s mapping from the annotations and the test
    features (a zip or a directory of ``*_i3d.npy``), keyed by the filename
    without ``_i3d.npy``; the frame count comes from each feature's clip
    count."""
    annots = parse_temporal_annotations(annotations_path)
    ground_truths: Dict[str, List[float]] = {}

    def handle(name: str, features: np.ndarray) -> None:
        stem = name.split("/")[-1].replace("_i3d.npy", "")
        events = annots[stem]
        ground_truths[stem] = frame_labels((events["first_event"], events["second_event"]),
                                           features.shape[0] * frames_per_clip)

    if os.path.isdir(test_features_path):
        for fname in sorted(os.listdir(test_features_path)):
            if fname.endswith(".npy"):
                handle(fname, np.load(os.path.join(test_features_path, fname), mmap_mode="r"))
    else:
        with zipfile.ZipFile(test_features_path) as zipf:
            for member in zipf.infolist():
                if member.is_dir() or not member.filename.endswith(".npy"):
                    continue
                with zipf.open(member) as f:
                    handle(member.filename, np.load(f))
    return ground_truths


def save_ground_truth(ground_truths: Dict[str, List[float]], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(ground_truths, f)
