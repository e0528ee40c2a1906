"""Helpers of the port's training-slice tests (``tests/test_torch_runner_*.py``)
that other port tests share: the narrow feature width, the narrow MGFN
overrides and a feature directory with its ground truth. Not a test module.
"""

import os

import numpy as np

from anomaly_detection_on_video_tpu_torch.data import gt as tgt


C = 64  # feature width of the narrow runs
NARROW_MGFN = ["runner.model_config.dims=[16,16,32]", "runner.model_config.depths=[1,1,1]",
               "runner.model_config.dim_head=8", f"runner.model_config.channels={C}",
               "runner.model_config.dropout_rate=0.0"]


def write_features(root, rng, n_train=4, test_clips=(20, 37, 12, 50)):
    """Train bags (10, 32, C) and test features (n, 10, C) with flow mates,
    a temporal annotation file, and the ground truth built from it."""
    train, test = os.path.join(root, "train"), os.path.join(root, "test")
    os.makedirs(train)
    os.makedirs(test)
    for i in range(n_train):
        for stem, shift in ((f"Normal_Videos_{i:03d}_x264", 0.0), (f"Abuse{i:03d}_x264", 0.8)):
            bag = np.abs(rng.randn(10, 32, C)) * 0.5 + (rng.rand(1, 32, 1) > 0.7) * shift
            np.save(os.path.join(train, f"{stem}_i3d.npy"), bag.astype(np.float32))
            np.save(os.path.join(train, f"{stem}_flow.npy"), rng.rand(10, 32, C).astype(np.float32))
    lines = []
    for i, n in enumerate(test_clips):
        normal = i % 2 == 0
        stem = f"Normal_Videos_{i:03d}_x264" if normal else f"Abuse{i:03d}_x264"
        np.save(os.path.join(test, f"{stem}_i3d.npy"),
                (np.abs(rng.randn(n, 10, C)) * 0.5).astype(np.float32))
        events = "-1  -1" if normal else f"{16 * 3}  {16 * 8}"
        lines.append(f"{stem}.mp4  {'Normal' if normal else 'Abuse'}  {events}  -1  -1")
    annotations = os.path.join(root, "annotations.txt")
    with open(annotations, "w") as f:
        f.write("\n".join(lines) + "\n")
    gt_path = os.path.join(root, "gt.json")
    tgt.save_ground_truth(tgt.build_ground_truth(annotations, test), gt_path)
    return train, test, annotations, gt_path
