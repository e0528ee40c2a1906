"""Score videos: video -> I3D features -> clip and frame anomaly scores.

The port's counterpart of the repository's ``infer.py``, its scorer side
and the one-shot scoring of a video set::

    python -m anomaly_detection_on_video_tpu_torch.infer --videos clips/ --outdir scores/ \\
        (--checkpoint <run dir> [--checkpoint-step latest|best|N]
         | --torch-weights <.pt> [--official]) \\
        [--model mgfn|rtfm|sultani] [--model-config k=v ...] \\
        [--threshold t --min-event-frames n] [--features-dir <cache>] \\
        [--frames-per-clip n] [--group-mode adaptive|fixed] [--warmup clips] \\
        [--i3d-model tushar-n-baseline|i3d_8x8_r50] [--i3d-weights i3res50.pt|I3D_8x8_R50.pyth] \\
        [--dtype bfloat16|float32|int8] [--batch 240] \\
        [--crops ten|center] [--stream rgb|flow|both] \\
        [--flow-backend host|device|tvl1] [--device cuda]

Writes ``<stem>_scores.json`` per video with the JAX CLI's keys (video,
model, stream, n_clips, frames_per_clip, clip_scores, frame_scores,
latency_s, and with ``--threshold`` the threshold and the ``events``:
contiguous frame runs scoring above it). ``--videos`` is a video file, a
glob, or a directory searched recursively (the UCF-Crime class
subfolders).

The scorer: ``--checkpoint`` is a directory written by the port's ``run``
(``<step>/state.pt`` and ``hparams.json``), whose persisted model family
and config are rebuilt unless ``--model`` is given, with ``--model-config``
keys applied on top. The JAX package's orbax checkpoints are not read:
export their weights with its ``utils/convert.py``
``export_{mgfn,rtfm,sultani}_state_dict`` and pass them as
``--torch-weights``, a state dict in the reference's layout (MGFN: the HF
names, ``--official`` for the official release's; RTFM: the official
release's, BatchNorms after a conv folded; Sultani: ``fc1``-``fc3``).
``--i3d-model`` picks the backbone (``tushar-n-baseline``, the default, or
``i3d_8x8_r50``); ``--i3d-weights`` is its weight file, read as the JAX
CLI's ``load_weights`` reads it (``load_i3d_weights``: a ``.pyth`` file's
``model_state`` unwrapped; ``i3d_8x8_r50`` weights in pytorchvideo's names),
with seeded random weights when unset, as the JAX CLI initializes randomly.

``--dtype int8`` runs the I3D convs in int8 (kernels K4 and K5) around
bfloat16 compute, with scales calibrated on the first video's first chunk
and pinned to ``--features-dir`` (else ``--outdir``) as
``act_scales_<stream>.json``. On an H100 it is currently slower than
bfloat16 and uses more memory (PERF.md, section 5). ``--crops center`` is
the throughput serving mode: one center crop per clip (ten-crop row 4), its
features cached as ``<stem>_i3d_center.npy``.

``--stream`` picks the features scored: ``rgb`` (2048-d), ``flow`` (the
optical-flow stream, 2048-d, cached as ``<stem>_flow.npy``) or ``both``
(RGB and flow from one decode pass, concatenated to 4096-d, as training's
``data.stream=both`` concatenates them). Unset, it is the checkpoint's
persisted ``data.stream`` (else ``rgb``), so a two-stream checkpoint is
scored two-stream with no flag. ``--flow-backend`` as in
``extract_features``; with ``--features-dir`` the backend is pinned there
in ``flow_backend.json``. Not ported: ``--figure``, ``--watch``,
``--serve``, ``--export`` / ``--from-export``, ``--data-parallel`` and
``--compile-cache``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .config import instantiate, locate
from .config.compose import parse_value
from .data.extraction import (
    FeatureExtractor,
    extract_video_two_stream,
    feature_filename,
    record_flow_backend,
)
from .data.features import pad_eval_batch
from .data.video import find_videos, warn_duplicate_stems
from .models import build_model
from .models.i3d import MODEL_ZOO
from .ops.metrics import anomaly_events, frame_level_scores
from .training.checkpoints import STATE_FILE, TopKCheckpointer
from .training.optim import adam_with_l2
from .training.runner import TrainState, buckets_up_to, eval_bucket, make_eval_step
from .utils.convert import (
    i3d_state_dict_from_pytorchvideo,
    mgfn_state_dict_from_official,
    rtfm_state_dict_from_official,
)
from .utils.device import resolve_device
from .utils.npyio import atomic_save

FEATURE_DIM = 2048  # one stream's features per crop


def load_state_dict(path: str) -> dict:
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state_dict, dict) and "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    return state_dict


def load_i3d_weights(path: str, model_name: str) -> dict:
    """An I3D weight file -> the port's state dict for ``model_name``, as
    the JAX CLIs' ``load_weights`` reads a torch file: a ``.pyth`` file's
    ``model_state`` (or a ``state_dict`` wrapper) unwrapped, then
    ``i3d_8x8_r50`` weights from pytorchvideo's names
    (``i3d_state_dict_from_pytorchvideo``); i3res50 weights already carry
    the reference's names."""
    state_dict = load_state_dict(path)
    if isinstance(state_dict, dict) and "model_state" in state_dict:
        state_dict = state_dict["model_state"]  # pytorchvideo .pyth layout
    if model_name == "tushar-n-baseline":
        return state_dict
    return i3d_state_dict_from_pytorchvideo(state_dict)


def _weights_to_port(model_name: str, state_dict: dict, official: bool) -> dict:
    """A reference-layout state dict -> the port model's names."""
    if model_name == "rtfm":
        return rtfm_state_dict_from_official(state_dict)
    if model_name == "mgfn" and official:
        return mgfn_state_dict_from_official(state_dict)
    return state_dict


def _parse_model_config(pairs: Optional[List[str]]) -> dict:
    overrides = {}
    for kv in pairs or []:
        key, _, value = kv.partition("=")
        try:
            # YAML-style values, as the run CLI's: dims=[64,128,1024], dropout_rate=0.7
            overrides[key] = parse_value(value)
        except ValueError as exc:
            raise SystemExit(f"--model-config {kv!r}: {exc}")
    return overrides


def build_scorer(args: argparse.Namespace) -> Tuple[nn.Module, str]:
    """(scorer on ``args.device`` in eval mode, its registry name) from the
    CLI's scorer flags, as the JAX CLI's ``build_scorer`` resolves them:
    the checkpoint's persisted model (``hparams.json``) unless ``--model``
    is given, ``--model-config`` on top, then the weights of
    ``--torch-weights`` or of the ``--checkpoint-step`` selected step.
    Path and selection mistakes exit with a one-line message before any
    extraction; a restore that does not fit the model raises ValueError."""
    checkpoint, torch_weights = args.checkpoint, args.torch_weights
    # fail fast on path typos: scoring with random weights would be garbage
    if checkpoint and not os.path.isdir(checkpoint):
        raise SystemExit(f"--checkpoint {checkpoint!r}: no such directory")
    if torch_weights and not os.path.isfile(torch_weights):
        raise SystemExit(f"--torch-weights {torch_weights!r}: no such file")
    if args.i3d_weights and not os.path.isfile(args.i3d_weights):
        raise SystemExit(f"--i3d-weights {args.i3d_weights!r}: no such file")

    overrides = _parse_model_config(args.model_config)
    metadata = TopKCheckpointer.load_metadata(checkpoint) if checkpoint else None
    if metadata and not args.model:
        node = dict(metadata.get("model_config") or {})
        node.update(overrides)
        model_name = metadata.get("model_name") or "mgfn"
        if "_target_" in node and metadata.get("model_class"):
            model = locate(metadata["model_class"])(instantiate(node))
        else:
            node.pop("_target_", None)
            _, model = build_model(model_name, **node)
    else:
        model_name = args.model or "mgfn"
        _, model = build_model(model_name, **overrides)

    if torch_weights:
        try:
            model.load_state_dict(_weights_to_port(model_name, load_state_dict(torch_weights),
                                                   args.official))
        except (KeyError, ValueError, RuntimeError) as exc:
            raise SystemExit(
                f"--torch-weights {torch_weights!r} does not look like a {model_name!r} state "
                f"dict ({type(exc).__name__}: {exc}); pass --model {{mgfn,rtfm,sultani}} "
                "matching the weights, or --official for the official MGFN release layout")
    elif checkpoint:
        ckpt = TopKCheckpointer(checkpoint)
        if ckpt.latest_step() is None:
            if any(name.isdigit() and not os.path.exists(os.path.join(checkpoint, name, STATE_FILE))
                   for name in os.listdir(checkpoint)):
                raise SystemExit(
                    f"--checkpoint {checkpoint!r}: its step directories hold no {STATE_FILE}; "
                    "it looks like a JAX (orbax) checkpoint, and the port reads only the "
                    "checkpoints its own run writes. Export the weights with the JAX package's "
                    "utils/convert.py export_{mgfn,rtfm,sultani}_state_dict, torch.save them, "
                    "and pass --torch-weights")
            raise SystemExit(f"--checkpoint {checkpoint!r}: directory contains no checkpoints "
                             "(expected a directory written by the port's run)")
        # only step selection errors map to the flag; a restore failure (a
        # --model-config override reshaping the model) raises as its own ValueError
        try:
            step = ckpt.resolve_step(args.checkpoint_step)
        except ValueError as exc:
            raise SystemExit(f"--checkpoint-step: {exc}")
        ckpt.restore(TrainState(model, adam_with_l2(model.parameters())), step=step)
    else:
        raise SystemExit("one of --checkpoint / --torch-weights is required")
    return model.to(resolve_device(args.device)).eval(), model_name


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


def _cache_path(features_dir: Optional[str], stem: str, stream: str,
                crops: str) -> Optional[str]:
    """``features_dir``'s file of one stream's features: ``<stem>_i3d.npy``
    or ``<stem>_flow.npy``, ``_center`` before ``.npy`` for center crops,
    so ``(n, 1, C)`` features neither shadow nor are shadowed by the
    ten-crop contract files."""
    if not features_dir:
        return None
    name = feature_filename(stem, stream)
    if crops == "center":
        name = name[: -len(".npy")] + "_center.npy"
    return os.path.join(features_dir, name)


def load_or_extract(path: str, extractor: FeatureExtractor,
                    flow_extractor: Optional[FeatureExtractor] = None,
                    features_dir: Optional[str] = None) -> np.ndarray:
    """One video's features for the active stream through the per-stream
    cache in ``features_dir`` (read where present, written on a miss):
    ``extractor``'s stream, or with ``flow_extractor`` both streams from
    one decode pass (``extract_video_two_stream``), concatenated RGB then
    flow on the feature axis, as training's ``data.stream=both``."""
    stem = os.path.splitext(os.path.basename(path))[0]
    if flow_extractor is not None:
        rgb_p = _cache_path(features_dir, stem, "rgb", extractor.crops)
        flow_p = _cache_path(features_dir, stem, "flow", extractor.crops)
        if rgb_p and os.path.exists(rgb_p) and os.path.exists(flow_p):
            rgb, flow = np.load(rgb_p), np.load(flow_p)
        else:
            rgb, flow = extract_video_two_stream(extractor, flow_extractor, path)
            if rgb_p:
                atomic_save(rgb_p, rgb)
                atomic_save(flow_p, flow)
        return np.concatenate([rgb, flow], axis=-1)
    cache = _cache_path(features_dir, stem, extractor.stream, extractor.crops)
    if cache and os.path.exists(cache):
        return np.load(cache)
    features = extractor.extract_video(path)
    if cache:
        atomic_save(cache, features)
    return features


def process_video(
    path: str,
    extractor: FeatureExtractor,
    scorer: nn.Module,
    outdir: str,
    model_name: str = "mgfn",
    threshold: Optional[float] = None,
    min_event_frames: int = 1,
    features_dir: Optional[str] = None,
    flow_extractor: Optional[FeatureExtractor] = None,
) -> dict:
    """Extract (or load from ``features_dir``, writing it on a miss, see
    ``load_or_extract``), score, and write ``<stem>_scores.json``; returns
    its content. The stream is ``extractor``'s, or ``both`` with
    ``flow_extractor``. With ``threshold`` the JSON carries the event
    windows."""
    start = time.time()
    stem = os.path.splitext(os.path.basename(path))[0]
    features = load_or_extract(path, extractor, flow_extractor, features_dir)
    clip_scores = score_features(features, scorer)
    frame_scores = frame_level_scores(clip_scores, extractor.frames_per_clip)
    out = {
        "video": os.path.basename(path),
        "model": model_name,
        "stream": "both" if flow_extractor is not None else extractor.stream,
        "n_clips": int(features.shape[0]),
        "frames_per_clip": extractor.frames_per_clip,
        "clip_scores": np.round(clip_scores, 6).tolist(),
        "frame_scores": np.round(frame_scores, 6).tolist(),
        "latency_s": round(time.time() - start, 3),
    }
    if threshold is not None:
        out["threshold"] = threshold
        out["events"] = anomaly_events(frame_scores, threshold, min_event_frames)
    os.makedirs(outdir, exist_ok=True)
    out_path = os.path.join(outdir, f"{stem}_scores.json")
    tmp_path = out_path + ".tmp"
    with open(tmp_path, "w") as f:
        json.dump(out, f)
    os.replace(tmp_path, out_path)
    print(f"{stem}: {out['n_clips']} clips, max score {clip_scores.max():.4f} -> {out_path}")
    return out


def extractor_kwargs(args: argparse.Namespace) -> dict:
    """``FeatureExtractor`` arguments for ``--dtype``, ``--batch`` and
    ``--crops``: int8 quantizes the convs around bfloat16 compute, as the
    JAX CLI does."""
    return {
        "dtype": torch.float32 if args.dtype == "float32" else torch.bfloat16,
        "quantize": args.dtype == "int8",
        "batch": args.batch,
        "crops": args.crops,
    }


def warmup(extractors: Sequence[FeatureExtractor], scorer: nn.Module, max_clips: int,
           channels: int) -> None:
    """Run each extractor's I3D forward once on a constant 240x320 clip
    (127: zero flow for the flow stream), unless its int8 still awaits
    calibration, which a constant chunk would degrade, and the scorer on
    every eval bucket a video of ``max_clips`` clips can hit: on the card
    this builds the kernels and picks cuDNN's algorithms before the first
    video."""
    start = time.time()
    for ex in extractors:
        if ex._needs_calibration:
            print(f"warmup: skipping {ex.stream} extractor (int8 awaits calibration on the "
                  "first real video)", flush=True)
        else:
            ex.extract_frames(np.full((ex.frames_per_clip, 240, 320, ex.channels), 127, np.uint8))
    buckets = buckets_up_to(max_clips)
    for bucket in buckets:
        score_features(np.zeros((bucket, extractors[0].n_crops, channels), np.float32), scorer)
    print(f"warmup done in {time.time() - start:.1f}s (eval buckets {buckets})", flush=True)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--videos", required=True,
                        help="video file, glob, or directory (searched recursively)")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="checkpoint directory written by the port's run")
    parser.add_argument("--checkpoint-step", default="latest",
                        help="which checkpoint to serve: latest (default), best (highest "
                             "recorded valid AUC), or an exact step number")
    parser.add_argument("--torch-weights", default=None,
                        help="scorer state dict (.pt) in the reference's layout")
    parser.add_argument("--official", action="store_true",
                        help="--torch-weights uses the official MGFN release layout instead of "
                             "the HF layout")
    parser.add_argument("--model", default=None, choices=["mgfn", "rtfm", "sultani"],
                        help="scorer family; defaults to the checkpoint's hparams.json (else mgfn)")
    parser.add_argument("--model-config", nargs="*", metavar="KEY=VALUE",
                        help="model config overrides (YAML-style values, e.g. dims=[64,128,1024]); "
                             "applied on top of the checkpoint's hparams")
    parser.add_argument("--i3d-model", default="tushar-n-baseline", choices=sorted(MODEL_ZOO),
                        help="I3D backbone of the features")
    parser.add_argument("--i3d-weights", default=None,
                        help="the backbone's weights: an I3Res50 state dict (.pt), or for "
                             "i3d_8x8_r50 a pytorchvideo file (.pyth); seeded random weights "
                             "if unset")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32", "int8"],
                        help="I3D compute dtype; int8 quantizes the convs (scales calibrated "
                             "on the first chunk and pinned to --features-dir or --outdir); "
                             "currently slower than bfloat16 on an H100 (PERF.md sec. 5)")
    parser.add_argument("--batch", type=int, default=240,
                        help="(clip, crop) forwards per extraction step")
    parser.add_argument("--group-mode", default="adaptive", choices=["adaptive", "fixed"],
                        help="'adaptive' (default) sizes each video's extraction group to the "
                             "video by a power-of-two ladder capped at --batch; 'fixed' always "
                             "uses the --batch-derived group")
    parser.add_argument("--crops", default="ten", choices=["ten", "center"],
                        help="'ten' = the reference ten-crop protocol; 'center' = serving mode, "
                             "one center crop per clip (scores equal running the scorer on "
                             "ten-crop row 4)")
    parser.add_argument("--stream", default=None, choices=["rgb", "flow", "both"],
                        help="feature stream(s) to extract and score: 'both' concatenates RGB + "
                             "optical-flow features (4096-d) for checkpoints trained with "
                             "data.stream=both; defaults to the checkpoint's persisted "
                             "data.stream (else rgb)")
    parser.add_argument("--flow-backend", default=None, choices=["host", "device", "tvl1"],
                        help="optical-flow algorithm for --stream flow/both (see "
                             "extract_features); default: device Farneback on a CUDA device, "
                             "host OpenCV on the CPU")
    parser.add_argument("--frames-per-clip", type=int, default=16)
    parser.add_argument("--features-dir", default=None,
                        help="cache and reuse <stem>_i3d.npy features here")
    parser.add_argument("--threshold", type=float, default=None,
                        help="emit anomaly events (contiguous frame runs scoring above this) in "
                             "the score JSON")
    parser.add_argument("--min-event-frames", type=int, default=1,
                        help="drop events shorter than this many frames (only with --threshold)")
    parser.add_argument("--warmup", type=int, default=0, metavar="CLIPS",
                        help="before the first video, run the I3D forward once and the scorer "
                             "on every eval bucket up to CLIPS clips")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.batch < 1:
        parser.error(f"--batch must be >= 1 (got {args.batch})")
    if args.threshold is not None and not 0.0 <= args.threshold <= 1.0:
        # scores are sigmoid outputs: an out-of-range threshold gives no or all-frame events
        parser.error(f"--threshold must be in [0, 1] (got {args.threshold}; frame scores are "
                     "sigmoid probabilities)")
    if args.threshold is not None and args.dtype == "int8":
        print("warning: --threshold with --dtype int8: absolute thresholds derived on bf16 scores "
              "may not transfer (frame scores shift up to ~0.5; AUC is stable). Re-derive the "
              "operating point on int8-scored data (scripts/operating_point.py); see "
              "docs/ROOFLINE.md.", file=sys.stderr)
    if args.crops == "center":
        # scorers are trained on ten-crop features; center-crop scores see crop row 4 only
        print("note: --crops center is the throughput serving mode; it scores ONE center crop "
              "per clip and measurably costs accuracy vs the reference ten-crop protocol "
              "(multi-seed AUC deltas: docs/int8_e2e.json protocol_cost; docs/ROOFLINE.md). "
              "Use --crops ten where accuracy matters more than latency.", file=sys.stderr)
    videos = find_videos(args.videos)
    if not videos:
        raise SystemExit(f"no videos match {args.videos!r}")
    os.makedirs(args.outdir, exist_ok=True)
    stream = args.stream
    if stream is None and args.checkpoint:
        # a data.stream=both run is scored two-stream with no flag
        stream = ((TopKCheckpointer.load_metadata(args.checkpoint) or {}).get("data")
                  or {}).get("stream")
    stream = stream or "rgb"
    # the scorer first: its path and weights checks fail before the extractor is built
    scorer, model_name = build_scorer(args)
    extracted_dim = 2 * FEATURE_DIM if stream == "both" else FEATURE_DIM
    scorer_dim = getattr(getattr(scorer, "config", None), "channels", extracted_dim)
    if scorer_dim != extracted_dim:
        if stream == "both":
            hint = f"retrain with data.stream=both or pass --model-config channels={extracted_dim}"
        elif scorer_dim == 2 * FEATURE_DIM:
            hint = "pass --stream both (this scorer was trained on concatenated RGB+flow features)"
        else:
            hint = f"pass --model-config channels={extracted_dim}"
        raise SystemExit(f"--stream {stream} extracts {extracted_dim}-d features but the "
                         f"{model_name} scorer expects {scorer_dim}-d input; {hint}")
    # one weight tree for both streams: the flow stem adapts from it
    state_dict = load_i3d_weights(args.i3d_weights, args.i3d_model) if args.i3d_weights else None
    device = resolve_device(args.device)

    def make_extractor(s: str) -> FeatureExtractor:
        return FeatureExtractor(
            model_name=args.i3d_model,
            state_dict=state_dict,
            frames_per_clip=args.frames_per_clip,
            adaptive_groups=args.group_mode == "adaptive",
            device=device,
            stream=s,
            flow_backend=args.flow_backend if s == "flow" else None,
            **extractor_kwargs(args),
        )

    extractor = make_extractor("flow" if stream == "flow" else "rgb")
    flow_extractor = make_extractor("flow") if stream == "both" else None
    if args.features_dir and stream != "rgb":
        # one flow definition per cache directory, as extract_features pins it
        try:
            record_flow_backend(args.features_dir, (flow_extractor or extractor).flow_backend)
        except ValueError as exc:
            raise SystemExit(str(exc))
    # one quantization per feature directory and stream, as the JAX CLI pins
    # it (no-op unless int8)
    extractors = [ex for ex in (extractor, flow_extractor) if ex is not None]
    for ex in extractors:
        ex.pin_calibration(args.features_dir or args.outdir)
    if args.warmup > 0:
        warmup(extractors, scorer, args.warmup, scorer_dim)
    # score JSONs are stem-keyed: same-stem videos of different subfolders would collide
    warn_duplicate_stems(videos, what="scored")
    for path in videos:
        try:
            process_video(path, extractor, scorer, args.outdir, model_name, args.threshold,
                          args.min_event_frames, args.features_dir, flow_extractor)
        except ValueError as exc:  # an undecodable file: a user problem, not a traceback
            raise SystemExit(f"{path}: {exc}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
