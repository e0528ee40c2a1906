"""Score videos: video -> I3D features -> MGFN clip and frame scores.

The port's counterpart of the repository's ``infer.py`` main path::

    python -m anomaly_detection_on_video_tpu_torch.infer \\
        --videos clips/ --outdir scores/ --torch-weights mgfn.pt \\
        [--i3d-weights i3res50.pt] [--dtype bfloat16|float32|int8] [--batch 240] [--device cuda]

Writes ``<stem>_scores.json`` per video with the same keys as the JAX
package's CLI (video, model, stream, n_clips, frames_per_clip, clip_scores,
frame_scores, latency_s). ``--torch-weights`` is an MGFN state dict in the
reference's HF layout; ``--i3d-weights`` an I3Res50 state dict (seeded
random weights when unset, as the JAX CLI initializes randomly).
``--dtype int8`` runs the I3D convs in int8 (kernels K4 and K5) around
bfloat16 compute, with scales calibrated on the first video's first chunk
and pinned to ``--outdir`` as ``act_scales_rgb.json``. On an H100 it is
currently slower than bfloat16 and uses more memory: the quantize and BN
passes around each int8 conv are separate elementwise kernels (PERF.md,
section 5).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from .data.extraction import FeatureExtractor
from .data.features import pad_eval_batch
from .models.mgfn import MGFN, MGFNConfig
from .ops.metrics import frame_level_scores
from .training.runner import eval_bucket, make_eval_step
from .utils.device import DeviceLike, resolve_device

VIDEO_EXTENSIONS = (".mp4", ".avi", ".mkv", ".mov", ".webm", ".mpg", ".mpeg")


def load_state_dict(path: str) -> dict:
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state_dict, dict) and "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    return state_dict


def build_scorer(
    state_dict: Optional[dict] = None,
    config: MGFNConfig = MGFNConfig(),
    device: DeviceLike = "cuda",
) -> nn.Module:
    """MGFN on ``device`` in eval mode, from a reference-named state dict."""
    model = MGFN(config)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model.to(resolve_device(device)).eval()


def score_features(features: np.ndarray, scorer: nn.Module, eval_step=None) -> np.ndarray:
    """(n_clips, n_crops, C) float32 features -> (n_clips,) clip scores,
    through one padded power-of-two bucket."""
    eval_step = eval_step or make_eval_step()
    device = next(scorer.parameters()).device
    n_clips = features.shape[0]
    feats = torch.from_numpy(pad_eval_batch(features, eval_bucket(n_clips))).to(device)
    length = torch.tensor([n_clips], device=device)
    scores = eval_step(scorer, feats, length)
    return scores[0, :n_clips, 0].cpu().numpy()


def process_video(
    path: str,
    extractor: FeatureExtractor,
    scorer: nn.Module,
    outdir: str,
) -> dict:
    """Extract, score and write ``<stem>_scores.json``; returns its content."""
    start = time.time()
    stem = os.path.splitext(os.path.basename(path))[0]
    features = extractor.extract_video(path)
    clip_scores = score_features(features, scorer)
    frame_scores = frame_level_scores(clip_scores, extractor.frames_per_clip)
    out = {
        "video": os.path.basename(path),
        "model": "mgfn",
        "stream": "rgb",
        "n_clips": int(features.shape[0]),
        "frames_per_clip": extractor.frames_per_clip,
        "clip_scores": np.round(clip_scores, 6).tolist(),
        "frame_scores": np.round(frame_scores, 6).tolist(),
        "latency_s": round(time.time() - start, 3),
    }
    os.makedirs(outdir, exist_ok=True)
    out_path = os.path.join(outdir, f"{stem}_scores.json")
    tmp_path = out_path + ".tmp"
    with open(tmp_path, "w") as f:
        json.dump(out, f)
    os.replace(tmp_path, out_path)
    print(f"{stem}: {out['n_clips']} clips, max score {clip_scores.max():.4f} -> {out_path}")
    return out


def list_videos(spec: str) -> List[str]:
    """A video file, a directory of videos, or a glob."""
    if os.path.isdir(spec):
        paths = [os.path.join(spec, n) for n in os.listdir(spec)
                 if n.lower().endswith(VIDEO_EXTENSIONS)]
    else:
        paths = glob.glob(spec)
    if not paths:
        raise SystemExit(f"--videos {spec!r}: no videos found")
    return sorted(paths)


def extractor_kwargs(args: argparse.Namespace) -> dict:
    """``FeatureExtractor`` arguments for ``--dtype``: int8 quantizes the
    convs around bfloat16 compute, as the JAX CLI does."""
    return {
        "dtype": torch.float32 if args.dtype == "float32" else torch.bfloat16,
        "quantize": args.dtype == "int8",
        "batch": args.batch,
    }


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--videos", required=True, help="video file, directory, or glob")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--torch-weights", required=True,
                        help="MGFN state dict (.pt), reference HF layout")
    parser.add_argument("--i3d-weights", default=None,
                        help="I3Res50 state dict (.pt); seeded random weights if unset")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32", "int8"],
                        help="I3D compute dtype; int8 quantizes the convs (scales calibrated "
                             "on the first chunk and pinned to --outdir); currently slower "
                             "than bfloat16 on an H100 (PERF.md sec. 5)")
    parser.add_argument("--batch", type=int, default=240,
                        help="(clip, crop) forwards per extraction step")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    extractor = FeatureExtractor(
        state_dict=load_state_dict(args.i3d_weights) if args.i3d_weights else None,
        adaptive_groups=True,
        device=device,
        **extractor_kwargs(args),
    )
    # one quantization per output directory, as the JAX CLI pins it
    extractor.pin_calibration(args.outdir)
    scorer = build_scorer(load_state_dict(args.torch_weights), device=device)
    for path in list_videos(args.videos):
        process_video(path, extractor, scorer, args.outdir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
