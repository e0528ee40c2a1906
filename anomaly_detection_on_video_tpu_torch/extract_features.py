"""Extract I3D features for a directory of videos::

    python -m anomaly_detection_on_video_tpu_torch.extract_features \\
        --videos clips/ --outdir features/ [--weights i3res50.pt] \\
        [--dtype bfloat16|float32|int8] [--batch 240] [--device cuda]

Writes ``<stem>_i3d.npy`` of shape ``(n_clips, 10, 2048)`` float32 per
video, the reference's on-disk contract, and skips videos whose file is
already there. ``--videos`` is a video file, a glob, or a directory
searched recursively (the UCF-Crime class subfolders); videos of
different folders that share a stem share one output file, and a warning
names them. Single host, RGB stream, ten crops. ``--dtype int8`` runs
the convs in int8 (kernels K4 and K5) around bfloat16 compute; its scales
calibrate on the first chunk extracted and are pinned to ``--outdir`` as
``act_scales_rgb.json``, the JAX package's sidecar, so a resumed run
quantizes as the first did. On an H100 int8 is currently slower than
bfloat16 and uses more memory (PERF.md, section 5). ``--weights`` is an
I3Res50 state dict (seeded random weights when unset).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from .data.extraction import FeatureExtractor, extract_videos
from .data.video import find_videos, warn_duplicate_stems
from .infer import extractor_kwargs, load_state_dict
from .utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--videos", required=True,
                        help="video file, glob, or directory (searched recursively)")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--weights", default=None,
                        help="I3Res50 state dict (.pt); seeded random weights if unset")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32", "int8"],
                        help="float32 for parity runs (exact resize); int8 quantizes the "
                             "convs, currently slower than bfloat16 on an H100 (PERF.md sec. 5)")
    parser.add_argument("--batch", type=int, default=240,
                        help="(clip, crop) forwards per extraction step")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    videos = find_videos(args.videos)
    if not videos:
        raise SystemExit(f"no videos found under {args.videos!r}")
    warn_duplicate_stems(videos, what="extracted")
    extractor = FeatureExtractor(
        state_dict=load_state_dict(args.weights) if args.weights else None,
        device=resolve_device(args.device),
        **extractor_kwargs(args),
    )
    n_done = extract_videos(videos, args.outdir, extractor)
    print(f"extracted {n_done} of {len(videos)} videos into {args.outdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
