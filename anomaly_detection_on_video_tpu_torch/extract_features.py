"""Extract I3D features for a directory of videos::

    python -m anomaly_detection_on_video_tpu_torch.extract_features \\
        --videos clips/ --outdir features/ [--split train|test] \\
        [--model tushar-n-baseline|i3d_8x8_r50] \\
        [--weights i3res50.pt|i3d.msgpack|I3D_8x8_R50.pyth] \\
        [--dtype bfloat16|float32|int8] [--batch 240] \\
        [--crops ten|center] [--decode-workers N] [--profile] \\
        [--stream rgb|flow|both] [--flow-backend host|device|tvl1] \\
        [--segment-length 32 | --no-segments] [--compile-cache DIR] [--device cuda] \\
        [--data-parallel] [--multihost [--coordinator HOST:PORT \\
         --num-processes N --process-id I]]

Writes ``<stem>_i3d.npy`` of shape ``(n_clips, 10, 2048)`` float32 per
video, the reference's on-disk contract, into ``--outdir`` (or
``<outdir>/<split>``), and skips videos whose file is already there. Then,
unless ``--no-segments`` or ``--split test``, pools every feature file into
``(10, L, 2048)`` training segments in ``<outdir>/segment_features_<L>``
(``--segment-length`` L, default 32), the training contract the port's
trainer reads. ``--videos`` is a video file, a glob, or a directory
searched recursively (the UCF-Crime class subfolders); videos of different
folders that share a stem share one output file, and a warning names them.

``--crops center`` is the serving protocol: one center crop per clip,
``(n_clips, 1, 2048)``, exactly ten-crop row 4, pinned per directory in
``crops.json``; it skips the segments (their contract is ten-crop).
``--decode-workers`` (default: one per core, at most 8) decodes that many
videos at once into one device queue; 1 is the serial path, which
``--profile`` forces to print its ``pipeline stages:`` timers.
``--stream flow`` writes the optical-flow stream's ``<stem>_flow.npy``
instead, ``--stream both`` both files from one decode pass (one extractor
per stream from one weight tree: the flow stem's two input channels start
from the RGB stem's mean). ``--flow-backend`` is ``host`` (OpenCV on the
host), ``device`` (Farneback on the card, the default there) or ``tvl1``
(TV-L1 on the card), pinned per directory in ``flow_backend.json``.
``--dtype int8`` runs the convs in int8 (kernels K4 and K5) around
bfloat16 compute; its scales calibrate on the first chunk extracted and
are pinned to the feature directory as ``act_scales_<stream>.json``, the
JAX package's sidecars, so a resumed run quantizes as the first did. On an H100
int8 is currently slower than bfloat16 and uses more memory (PERF.md,
section 5). ``--model`` picks the backbone, ``tushar-n-baseline`` (the
default) or ``i3d_8x8_r50``, for both streams; ``--weights`` is its weight
file, read as the JAX CLI's ``load_weights`` reads it (flax variables in a
``.msgpack`` file, an I3Res50 state dict, or for ``i3d_8x8_r50`` a
pytorchvideo ``.pyth`` whose ``model_state`` is converted), with seeded
random weights when unset;
keys the model does not have (a Kinetics head) are dropped with a printed
line, as the JAX converter ignores them. ``--compile-cache DIR`` builds the
CUDA kernels into DIR and loads them from there
(``utils/compile_cache.py``).

``--data-parallel`` splits the clip axis of every group over the visible
cards (``FeatureExtractor(devices=...)``); with one card it changes
nothing. ``--multihost`` is a sweep by several processes, as the JAX CLI
runs it: they meet at a store (``--coordinator host:port`` with
``--num-processes`` and ``--process-id``, or torchrun's environment), which
is all they share, so several may run on one card. Under ``--dtype int8``
process 0 first calibrates on the first video and pins
``act_scales_<stream>.json``; after a barrier each process extracts
``videos[i::n]`` into the shared output directory, and after another only
process 0 pools the segments. ``--hf-dataset`` is not ported (it needs the
network), and is refused.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .data.extraction import (
    FeatureExtractor,
    extract_videos,
    extract_videos_pooled,
    extract_videos_two_stream,
)
from .data.segments import segment_video_features
from .data.video import find_videos, warn_duplicate_stems
from .infer import extractor_kwargs, load_i3d_weights
from .models.i3d import MODEL_ZOO
from .parallel import barrier, initialize_multihost, process_count, process_index, shutdown
from .utils.compile_cache import enable_compile_cache
from .utils.device import resolve_device
from .utils.profiling import StageTimer

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--videos", help="video file, glob, or directory (searched recursively)")
    parser.add_argument("--hf-dataset", help="not ported: HF dataset id (network mode)")
    parser.add_argument("--outdir", required=True)
    parser.add_argument("--split", default=None, choices=[None, "train", "test"],
                        help="subdirectory under outdir; train also gets segments")
    parser.add_argument("--model", default="tushar-n-baseline", choices=sorted(MODEL_ZOO),
                        help="I3D backbone")
    parser.add_argument("--weights", default=None,
                        help="the backbone's weights: flax variables (.msgpack, any backbone), an "
                             "I3Res50 state dict (.pt), or for i3d_8x8_r50 a pytorchvideo file "
                             "(.pyth); seeded random weights if unset")
    parser.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32", "int8"],
                        help="float32 for parity runs (exact resize); int8 quantizes the "
                             "convs, currently slower than bfloat16 on an H100 (PERF.md sec. 5)")
    parser.add_argument("--batch", type=int, default=240,
                        help="(clip, crop) forwards per extraction step")
    parser.add_argument("--segment-length", type=int, default=32)
    parser.add_argument("--no-segments", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="report decode/device stage timers")
    parser.add_argument("--crops", default="ten", choices=["ten", "center"],
                        help="ten = the reference ten-crop protocol ((n_clips, 10, 2048), "
                             "required for the training contract); center = 1-crop serving "
                             "mode ((n_clips, 1, 2048), equal to ten-crop row 4 at a tenth of "
                             "the FLOPs); the protocol pins per outdir so resumes cannot mix "
                             "the two")
    parser.add_argument("--decode-workers", type=int, default=None,
                        help=">1 decodes that many videos concurrently to keep the device "
                             "fed; default: one per host core (capped at 8), 1 = serial")
    parser.add_argument("--stream", default="rgb", choices=["rgb", "flow", "both"],
                        help="RGB, optical flow, or both from one shared decode pass")
    parser.add_argument("--flow-backend", default=None, choices=["host", "device", "tvl1"],
                        help="Farneback on the host (OpenCV), Farneback on the device, or "
                             "TV-L1 on the device (the original two-stream I3D protocol's "
                             "flow); default: device on a CUDA device, host on the CPU")
    parser.add_argument("--compile-cache", default=None, metavar="DIR",
                        help="persistent nvcc kernel build directory: repeated runs load the "
                             "built kernels instead of compiling them again "
                             "(utils/compile_cache.py)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--data-parallel", action="store_true",
                        help="split the clip axis over every visible card (one card: no change)")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-process sweep: join the other processes (torchrun's "
                             "environment, or --coordinator), extract this process's share of "
                             "the videos into the shared outdir; process 0 pins int8 scales "
                             "first and pools segments after a barrier")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0's store when not under torchrun (requires "
                             "--num-processes and --process-id)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.multihost and args.hf_dataset:
        parser.error("--multihost supports --videos local mode only")
    if args.hf_dataset:
        parser.error("--hf-dataset is not ported (it needs the network); pass --videos")
    if not args.videos:
        parser.error("one of --videos / --hf-dataset is required")
    if args.batch < 1:
        parser.error(f"--batch must be >= 1 (got {args.batch})")
    if args.flow_backend and args.stream == "rgb":
        print("warning: --flow-backend has no effect with --stream rgb (no optical-flow stream "
              "is extracted)", file=sys.stderr)
    videos = find_videos(args.videos)
    if not videos:
        raise SystemExit(f"no videos found under {args.videos!r}")
    warn_duplicate_stems(videos, what="extracted")
    if args.compile_cache:  # before the first extractor builds the kernels
        enable_compile_cache(args.compile_cache)
    # one weight tree for both streams: the flow stem adapts from it
    state_dict = load_i3d_weights(args.weights, args.model) if args.weights else None
    device = resolve_device(args.device)
    if args.multihost:  # the store only: the processes share no collective
        device = initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                      autodetect=args.coordinator is None, device=device,
                                      process_group=False)
    try:
        return _extract(args, videos, state_dict, device)
    except BaseException:
        shutdown(clean=False)
        raise


def _extract(args: argparse.Namespace, videos: List[str], state_dict, device) -> int:
    import torch

    devices = None
    if args.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    def make_extractor(stream: str) -> FeatureExtractor:
        return FeatureExtractor(model_name=args.model, state_dict=state_dict, device=device,
                                devices=devices, stream=stream,
                                flow_backend=args.flow_backend if stream == "flow" else None,
                                **extractor_kwargs(args))

    extractor = make_extractor("rgb" if args.stream == "both" else args.stream)
    flow_extractor = make_extractor("flow") if args.stream == "both" else None
    timer = StageTimer() if args.profile else None
    decode_workers = args.decode_workers
    if decode_workers is None:
        decode_workers = min(8, os.cpu_count() or 1)
    if timer is not None and decode_workers > 1:
        # the pooled path has no per-stage timers (decode runs in a pool)
        print("--profile forces --decode-workers 1 (serial path)", file=sys.stderr)
        decode_workers = 1

    outdir = os.path.join(args.outdir, args.split) if args.split else args.outdir
    pi, pc = process_index(), process_count()
    if pc > 1:
        if args.dtype == "int8":
            # one process owns the calibration: process 0 calibrates on the
            # global first video and pins the scales before anyone extracts
            if pi == 0:
                extractor.ensure_calibrated(outdir, videos[0])
                if flow_extractor is not None:
                    flow_extractor.ensure_calibrated(outdir, videos[0])
            barrier("int8 scales pinned")
        videos = videos[pi::pc]
    if decode_workers > 1:
        n = extract_videos_pooled(videos, outdir, extractor, flow_extractor,
                                  decode_workers=decode_workers)
    elif flow_extractor is not None:
        n = extract_videos_two_stream(videos, outdir, extractor, flow_extractor, timer=timer)
    else:
        n = extract_videos(videos, outdir, extractor, timer=timer)
    who = f"[process {pi}/{pc}] " if pc > 1 else ""
    print(f"{who}extracted {n} new videos ({len(videos)} total) -> {outdir}", flush=True)
    if pc > 1:
        # every feature file exists before process 0 pools the segments
        barrier("extraction complete")
    shutdown()
    if pi != 0:
        return 0
    train_dir = outdir if args.split in (None, "train") else None
    if timer is not None:
        print("pipeline stages:", timer.report())
    if args.crops == "center" and train_dir and not args.no_segments:
        # 32-segment pooling is the ten-crop training contract; 1-crop
        # features are a serving protocol and cannot feed it
        print("--crops center is a serving protocol; skipping 32-segment pooling (the "
              "training contract requires ten-crop)", file=sys.stderr)
        train_dir = None
    if train_dir and not args.no_segments:
        seg_dir = os.path.join(args.outdir, f"segment_features_{args.segment_length}")
        written = segment_video_features(train_dir, seg_dir, args.segment_length)
        print(f"segmented {written} feature files -> {seg_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
