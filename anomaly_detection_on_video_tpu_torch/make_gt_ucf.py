"""Frame-level ground-truth builder (counterpart of the repository-root
``make_gt_ucf.py``), local files only:

    python -m anomaly_detection_on_video_tpu_torch.make_gt_ucf \\
        --annotations Temporal_Anomaly_Annotation.txt --features test_dir \\
        --out ground_truth/ground_truth_ucf_crime.json

Writes ``ground_truth.json``: each test video's frame-level 0/1 labels
(n_clips * 16 frames, annotated event windows set to 1).
"""

from __future__ import annotations

import argparse
import os

from .data.gt import build_ground_truth, save_ground_truth


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--annotations", required=True, help="temporal annotation txt")
    parser.add_argument("--features", required=True, help="test feature zip or directory")
    parser.add_argument("--out", default="ground_truth/ground_truth_ucf_crime.json")
    parser.add_argument("--frames-per-clip", type=int, default=16)
    args = parser.parse_args(argv)
    if not os.path.exists(args.annotations):
        parser.error(f"--annotations {args.annotations!r}: no such file")
    if not os.path.exists(args.features):
        parser.error(f"--features {args.features!r}: no such file or directory")
    gt = build_ground_truth(args.annotations, args.features, args.frames_per_clip)
    save_ground_truth(gt, args.out)
    print(f"wrote ground truth for {len(gt)} videos -> {args.out}")


if __name__ == "__main__":
    main()
