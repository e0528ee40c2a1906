"""Score videos: video -> I3D features -> clip and frame anomaly scores.

The port's counterpart of the repository's ``infer.py``: one-shot scoring
of a video set, and serving on one device (a watched directory, an HTTP
endpoint, an exported scorer)::

    python -m anomaly_detection_on_video_tpu_torch.infer --videos clips/ --outdir scores/ \\
        (--checkpoint <run dir> [--checkpoint-step latest|best|N]
         | --torch-weights <.pt> [--official]) \\
        [--model mgfn|rtfm|sultani] [--model-config k=v ...] \\
        [--threshold t --min-event-frames n] [--features-dir <cache>] \\
        [--frames-per-clip n] [--group-mode adaptive|fixed] [--warmup clips] \\
        [--i3d-model tushar-n-baseline|i3d_8x8_r50] \\
        [--i3d-weights i3res50.pt|i3d.msgpack|I3D_8x8_R50.pyth] \\
        [--dtype bfloat16|float32|int8] [--batch 240] \\
        [--crops ten|center] [--stream rgb|flow|both] \\
        [--flow-backend host|device|tvl1] [--compile-cache DIR] [--device cuda] \\
        [--watch [--poll-interval s] [--idle-exit s] | --serve PORT [--serve-host H]]
    python -m anomaly_detection_on_video_tpu_torch.infer --outdir x (--checkpoint ... |
        --torch-weights ...) --export DIR [--export-max-clips 1024]
    python -m anomaly_detection_on_video_tpu_torch.infer --from-export DIR --videos ... --outdir ...

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
CLI's ``load_weights`` reads it (``load_i3d_weights``: flax variables in a
``.msgpack`` file; a ``.pyth`` file's ``model_state`` unwrapped;
``i3d_8x8_r50`` weights in pytorchvideo's names),
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
in ``flow_backend.json``.

Serving, as the JAX CLI serves. ``--watch`` polls ``--videos`` every
``--poll-interval`` seconds and scores each new video once its size is
stable across two polls; scoring is idempotent (a video with a score JSON
is skipped), a failure writes ``<stem>_scores.error.json`` (retried when
the file changes, or after a cooldown when it looks transient), and
``<outdir>/_serving_stats.json`` is rewritten every poll; ``--idle-exit``
ends the loop after that many seconds without pending work. ``--serve
PORT`` is an HTTP endpoint (stdlib; port 0 picks a free one, printed):
``POST /score?name=v.mp4`` with the video's bytes returns the score JSON
(idempotent per stem), ``GET /scores/<stem>``, ``/healthz`` and ``/stats``
answer beside it; scoring is serialized on one lock, and SIGTERM / SIGINT
finish the request in flight and shut down. ``--export DIR`` writes the
scorer as ``torch.export`` programs, one per eval bucket up to
``--export-max-clips`` clips, and a ``manifest.json`` (``utils/aot.py``),
and exits; ``--from-export DIR`` scores with them in place of the
checkpoint and model flags. ``--compile-cache DIR`` builds the CUDA
kernels into DIR and loads them from there (``utils/compile_cache.py``),
so a restarted server does not run nvcc again. ``--data-parallel``
splits the clip axis of extraction over every visible card
(``FeatureExtractor(devices=...)``; one card: no change), scores equal to
one card's. Not ported: ``--figure``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import sys
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence, Tuple, Union
from urllib.parse import parse_qs, unquote, urlparse

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
from .utils.aot import (
    ExportedScorer,
    artifact_path,
    export_buckets,
    export_scorer,
    save_scorer_export,
)
from .utils.compile_cache import enable_compile_cache
from .utils.convert import (
    i3d_state_dict_from_flax,
    i3d_state_dict_from_pytorchvideo,
    load_known_keys,
    mgfn_key_refused,
    mgfn_state_dict_from_official,
    rtfm_state_dict_from_official,
)
from .utils.device import resolve_device
from .utils.npyio import atomic_save, atomic_write_bytes
from .utils.serialization import load_variables

FEATURE_DIM = 2048  # one stream's features per crop
Scorer = Union[nn.Module, ExportedScorer]  # a live model or its exported programs


def load_state_dict(path: str) -> dict:
    state_dict = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state_dict, dict) and "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    return state_dict


def load_i3d_weights(path: str, model_name: str) -> dict:
    """An I3D weight file -> the port's state dict for ``model_name``, as
    the JAX CLIs' ``load_weights`` reads it: a ``.msgpack`` file holds flax
    variables (``scripts/convert_checkpoint.py --kind i3d``'s output), read
    by the port's own codec and mapped by ``i3d_state_dict_from_flax`` for
    every backbone; a torch file's ``.pyth`` ``model_state`` (or a
    ``state_dict`` wrapper) is unwrapped, then ``i3d_8x8_r50`` weights are
    taken from pytorchvideo's names (``i3d_state_dict_from_pytorchvideo``);
    i3res50 weights already carry the reference's names."""
    if path.endswith(".msgpack"):
        return i3d_state_dict_from_flax(load_variables(path))
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
            # keys the model lacks are dropped and named, as the JAX
            # converters ignore them; MGFN keeps refusing the keys its
            # JAX converter refuses
            load_known_keys(model, _weights_to_port(model_name, load_state_dict(torch_weights),
                                                    args.official),
                            f"--torch-weights {torch_weights!r}",
                            refuse=mgfn_key_refused if model_name == "mgfn" else None)
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


def score_features(features: np.ndarray, scorer: Scorer, eval_step=None) -> np.ndarray:
    """(n_clips, n_crops, C) float32 features -> (n_clips,) clip scores,
    through one padded power-of-two bucket: the live ``scorer``'s eval
    step, or an ``ExportedScorer``'s program of the bucket."""
    if isinstance(scorer, ExportedScorer):
        return scorer.score(features)
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
    scorer: Scorer,
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


def warmup(extractors: Sequence[FeatureExtractor], scorer: Scorer, max_clips: int,
           channels: int) -> None:
    """Run each extractor's I3D forward once on a constant 240x320 clip
    (127: zero flow for the flow stream), unless its int8 still awaits
    calibration, which a constant chunk would degrade, and the scorer on
    every eval bucket a video of ``max_clips`` clips can hit (an exported
    scorer: those it has programs for): on the card this builds the
    kernels and picks cuDNN's algorithms before the first video."""
    start = time.time()
    for ex in extractors:
        if ex._needs_calibration:
            print(f"warmup: skipping {ex.stream} extractor (int8 awaits calibration on the "
                  "first real video)", flush=True)
        else:
            ex.extract_frames(np.full((ex.frames_per_clip, 240, 320, ex.channels), 127, np.uint8))
    buckets = buckets_up_to(max_clips)
    if isinstance(scorer, ExportedScorer):
        buckets = [b for b in buckets if b <= scorer.buckets[-1]]
    for bucket in buckets:
        score_features(np.zeros((bucket, extractors[0].n_crops, channels), np.float32), scorer)
    print(f"warmup done in {time.time() - start:.1f}s (eval buckets {buckets})", flush=True)


def new_serving_stats() -> dict:
    """The counters both serving modes keep (``--watch``'s
    ``_serving_stats.json``, ``--serve``'s ``/stats``)."""
    return {"started_unix": round(time.time(), 1), "videos_scored": 0, "clips_scored": 0,
            "errors": 0}


def record_scored(stats: dict, res: dict) -> None:
    stats["videos_scored"] += 1
    stats["clips_scored"] += res["n_clips"]
    stats["last_video"] = res["video"]
    stats["last_latency_s"] = res["latency_s"]


def serve_http(args: argparse.Namespace, process: Callable[[str], dict],
               on_ready: Optional[Callable[[ThreadingHTTPServer], None]] = None) -> None:
    """The HTTP scoring endpoint of ``--serve PORT`` on ``--serve-host``
    (the JAX CLI's ``serve_http``), stdlib only.

    Routes:
      POST /score?name=<file>   the video's bytes -> its score JSON (idempotent:
                                a stem already scored answers from its JSON)
      GET  /scores/<stem>       a score JSON written before
      GET  /healthz             liveness, answered while a request scores
      GET  /stats               counters, the last latency, uptime

    Each upload is spooled into its own directory under ``<outdir>/_spool``,
    removed after the request. Scoring is serialized on one lock (one
    device queue); health and stats are answered from other threads. The
    handler threads are not daemons, so SIGTERM / SIGINT finish the request
    in flight and shut down (where handlers can be installed: the main
    thread). ``on_ready(server)`` is called once the socket is bound, so a
    caller in this process can read ``server.server_port`` and call
    ``server.shutdown()``."""
    score_lock = threading.Lock()
    stats = new_serving_stats()
    spool = os.path.join(args.outdir, "_spool")
    device_type = torch.device(args.device).type

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # one line per request, on stdout
            print(f"{self.address_string()} {fmt % a}", flush=True)

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                return self._json(200, {"ok": True, "device": device_type,
                                        "scoring": score_lock.locked()})
            if path == "/stats":
                return self._json(200, dict(stats, uptime_s=round(
                    time.time() - stats["started_unix"], 1)))
            if path.startswith("/scores/"):
                stem = os.path.basename(unquote(path[len("/scores/"):]))
                score_path = os.path.join(args.outdir, f"{stem}_scores.json")
                if os.path.exists(score_path):
                    with open(score_path) as f:
                        return self._json(200, json.load(f))
                return self._json(404, {"error": f"{stem} not scored"})
            return self._json(404, {"error": f"unknown path {path!r}"})

        def _drain_body(self) -> None:
            """Read and drop the request body, so closing the socket does
            not reset the queued answer under the client."""
            remaining = int(self.headers.get("Content-Length") or 0)
            while remaining > 0:
                chunk = self.rfile.read(min(1 << 20, remaining))
                if not chunk:
                    break
                remaining -= len(chunk)

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/score":
                self._drain_body()
                return self._json(404, {"error": f"unknown path {url.path!r}"})
            name = os.path.basename(parse_qs(url.query).get("name", ["upload.mp4"])[0])
            if name in ("", ".", ".."):  # the basename of 'x/..' is '..', a directory
                self._drain_body()
                return self._json(400, {"error": f"invalid name {name!r}"})
            stem = os.path.splitext(name)[0]
            score_path = os.path.join(args.outdir, f"{stem}_scores.json")
            if os.path.exists(score_path):  # idempotent per stem
                self._drain_body()
                with open(score_path) as f:
                    return self._json(200, json.load(f))
            length = int(self.headers.get("Content-Length") or 0)
            if length <= 0:
                return self._json(400, {"error": "empty request body"})
            # a directory per request: concurrent uploads of one name must
            # not overwrite or delete each other's bytes; the name (the
            # score stem) is kept inside it
            os.makedirs(spool, exist_ok=True)
            req_dir = tempfile.mkdtemp(dir=spool)
            video_path = os.path.join(req_dir, name)
            try:
                remaining = length
                with open(video_path, "wb") as f:  # bounded memory per upload
                    while remaining > 0:
                        chunk = self.rfile.read(min(1 << 20, remaining))
                        if not chunk:
                            break
                        f.write(chunk)
                        remaining -= len(chunk)
                with score_lock:
                    if os.path.exists(score_path):
                        # an upload of the same stem won the race while this
                        # one spooled: answer with its scores, extract once
                        with open(score_path) as f:
                            res = json.load(f)
                    else:
                        res = process(video_path)
                        record_scored(stats, res)
                return self._json(200, res)
            except Exception as exc:  # one bad upload must not stop serving
                stats["errors"] += 1
                return self._json(500, {"error": str(exc)})
            finally:
                shutil.rmtree(req_dir, ignore_errors=True)

    server = ThreadingHTTPServer((args.serve_host, args.serve), Handler)
    # ThreadingHTTPServer's daemon threads would let the interpreter exit
    # in the middle of a request; non-daemon ones make server_close() wait
    server.daemon_threads = False

    def _shutdown(signum, frame):
        print(f"signal {signum}: shutting down", flush=True)
        # shutdown() must not run on the serve_forever thread (it would deadlock)
        threading.Thread(target=server.shutdown, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _shutdown)
        except ValueError:
            pass  # not the main thread
    print(f"serving on {args.serve_host}:{server.server_port}", flush=True)
    try:
        if on_ready is not None:
            on_ready(server)
        server.serve_forever()
    finally:
        server.server_close()


def watch_videos(args: argparse.Namespace, process: Callable[[str], dict]) -> None:
    """The ``--watch`` loop (the JAX CLI's): poll ``args.videos`` every
    ``--poll-interval`` seconds and score each video once its size is the
    same at two polls (its producer finished writing), skipping what is
    scored. A failure writes ``<stem>_scores.error.json`` with the size and
    whether it is ``retryable``: a ValueError or FileNotFoundError is the
    file's fault and retried only when its size changes, anything else
    after ``max(30, 2 x poll)`` seconds. ``_serving_stats.json`` is
    rewritten atomically at every poll. With ``--idle-exit`` the loop ends
    that many seconds after the last pending work (a video growing, new,
    or waiting out a retry)."""
    error_retry_s = max(30.0, 2.0 * args.poll_interval)

    def video_status(path: str, size: int) -> str:
        """``done`` (scored, or failed for good at this size), ``cooldown``
        (a transient failure waiting to retry: pending work for the
        idle-exit clock) or ``ready``."""
        stem = os.path.splitext(os.path.basename(path))[0]
        if os.path.exists(os.path.join(args.outdir, f"{stem}_scores.json")):
            return "done"
        err_path = os.path.join(args.outdir, f"{stem}_scores.error.json")
        if os.path.exists(err_path):
            try:
                with open(err_path) as f:
                    err = json.load(f)
            except (OSError, ValueError):
                return "ready"
            if err.get("size") != size:
                return "ready"
            if not err.get("retryable", False):
                return "done"
            try:
                age = time.time() - os.path.getmtime(err_path)
            except OSError:
                return "ready"
            return "cooldown" if age < error_retry_s else "ready"
        return "ready"

    stats = new_serving_stats()

    def write_stats(n_watching: int) -> None:
        snap = dict(stats, watching=n_watching,
                    uptime_s=round(time.time() - stats["started_unix"], 1))
        atomic_write_bytes(os.path.join(args.outdir, "_serving_stats.json"),
                           json.dumps(snap).encode())

    last_sizes: dict = {}
    last_new = time.time()
    print(f"watching {args.videos!r} every {args.poll_interval:g}s (idle-exit: {args.idle_exit})",
          flush=True)
    while True:
        sizes = {}
        for path in find_videos(args.videos):
            try:
                sizes[path] = os.path.getsize(path)
            except OSError:
                continue  # gone between the listing and the stat
        for path, size in sorted(sizes.items()):
            status = video_status(path, size)
            if status == "done":
                continue
            if status == "cooldown":
                last_new = time.time()  # pending: the idle clock must not run out under it
                continue
            if last_sizes.get(path) != size:
                last_new = time.time()  # new or still growing
                continue
            try:
                record_scored(stats, process(path))
            except Exception as exc:  # one bad file must not stop serving
                stats["errors"] += 1
                print(f"warning: {path}: {exc}", file=sys.stderr)
                stem = os.path.splitext(os.path.basename(path))[0]
                # valid scores written before a late failure stay untouched
                if not os.path.exists(os.path.join(args.outdir, f"{stem}_scores.json")):
                    with open(os.path.join(args.outdir, f"{stem}_scores.error.json"), "w") as f:
                        json.dump({"video": os.path.basename(path), "error": str(exc),
                                   "size": size,
                                   # an undecodable file or one over the largest
                                   # exported bucket is the file's fault; a device
                                   # or memory failure may pass
                                   "retryable": not isinstance(exc, (ValueError,
                                                                     FileNotFoundError))}, f)
            last_new = time.time()
        last_sizes = sizes
        write_stats(len(sizes))
        if args.idle_exit is not None and time.time() - last_new > args.idle_exit:
            print("idle; exiting watch loop", flush=True)
            return
        time.sleep(args.poll_interval)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--videos", default=None,
                        help="video file, glob, or directory (searched recursively; required "
                             "except under --serve, where videos arrive over HTTP, and "
                             "--export)")
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
                        help="the backbone's weights: flax variables (.msgpack, any backbone), an "
                             "I3Res50 state dict (.pt), or for i3d_8x8_r50 a pytorchvideo file "
                             "(.pyth); seeded random weights if unset")
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
    parser.add_argument("--compile-cache", default=None, metavar="DIR",
                        help="persistent nvcc kernel build directory: serving restarts (--watch, "
                             "--serve) and repeated runs load the built kernels instead of "
                             "compiling them again (utils/compile_cache.py)")
    parser.add_argument("--watch", action="store_true",
                        help="serving loop: poll --videos and score new videos as they arrive "
                             "(skip already-scored; wait for file sizes to stabilize)")
    parser.add_argument("--poll-interval", type=float, default=5.0,
                        help="--watch poll period in seconds")
    parser.add_argument("--idle-exit", type=float, default=None,
                        help="--watch: exit after this many seconds with no new videos "
                             "(default: run forever)")
    parser.add_argument("--serve", type=int, default=None, metavar="PORT",
                        help="HTTP scoring endpoint (stdlib, no extra deps): POST "
                             "/score?name=v.mp4 with raw video bytes returns the score JSON; GET "
                             "/healthz, /stats, /scores/<stem>. Scoring serializes on the device; "
                             "health/stats stay responsive. Port 0 picks a free port (printed). "
                             "SIGTERM shuts down gracefully.")
    parser.add_argument("--serve-host", default="127.0.0.1",
                        help="--serve bind address (0.0.0.0 to expose)")
    parser.add_argument("--export", default=None, metavar="DIR",
                        help="export the scorer (weights included, one torch.export program per "
                             "eval bucket, on --device) to DIR and exit; serve the artifacts "
                             "with --from-export (utils/aot.py)")
    parser.add_argument("--export-max-clips", type=int, default=1024,
                        help="--export covers every eval bucket a video of up to this many clips "
                             "can hit")
    parser.add_argument("--from-export", default=None, metavar="DIR",
                        help="score with an artifact directory written by --export instead of a "
                             "checkpoint (no model rebuild)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--data-parallel", action="store_true",
                        help="split the clip axis of feature extraction over every visible card "
                             "(extract_features --data-parallel's serving analog; one card: no "
                             "change)")
    return parser


def check_args(parser: argparse.ArgumentParser, args: argparse.Namespace) -> None:
    """The JAX CLI's flag checks, in its order and wording (parser errors,
    exit code 2), and its warnings."""
    if args.watch and args.serve is not None:
        parser.error("--watch and --serve are mutually exclusive")
    if args.export and args.from_export:
        parser.error("--export and --from-export are mutually exclusive")
    if args.export and (args.watch or args.serve is not None):
        parser.error("--export writes the artifacts and exits; it cannot be combined with "
                     "--watch/--serve")
    if args.from_export and (args.checkpoint or args.torch_weights or args.model
                             or args.model_config):
        parser.error("--from-export replaces the checkpoint/model flags: the artifact "
                     "directory is self-describing")
    if args.export_max_clips < 1:
        parser.error("--export-max-clips must be >= 1")
    if args.serve is not None and not 0 <= args.serve <= 65535:
        # 0: a free port picked by the system (printed)
        parser.error(f"--serve port must be in [0, 65535] (got {args.serve})")
    if args.videos is None and args.serve is None and not args.export:
        parser.error("--videos is required (unless --serve or --export)")
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


def write_export(args: argparse.Namespace, scorer: nn.Module, model_name: str, channels: int,
                 stream: str) -> None:
    """``--export``: the scorer's programs for every bucket up to
    ``--export-max-clips`` clips, on ``--device``, and the manifest."""
    start = time.time()
    n_crops = 10 if args.crops == "ten" else 1
    buckets = export_buckets(args.export_max_clips)
    programs = export_scorer(scorer, channels=channels, n_crops=n_crops, buckets=buckets,
                             device=args.device)
    manifest_path = save_scorer_export(args.export, programs, model_name=model_name,
                                       channels=channels, n_crops=n_crops, stream=stream,
                                       device=args.device)
    total_kb = sum(os.path.getsize(artifact_path(args.export, b)) for b in buckets) // 1024
    print(f"exported {model_name} scorer for buckets {buckets} ({n_crops} crops, {channels}-d, "
          f"{total_kb} KB) in {time.time() - start:.1f}s -> {manifest_path}")


def main(argv: Optional[List[str]] = None,
         on_ready: Optional[Callable[[ThreadingHTTPServer], None]] = None) -> int:
    """The CLI; ``on_ready`` goes to ``serve_http`` under ``--serve``."""
    parser = build_parser()
    args = parser.parse_args(argv)
    check_args(parser, args)
    videos = find_videos(args.videos) if args.videos else []
    if not videos and not args.watch and args.serve is None and not args.export:
        raise SystemExit(f"no videos match {args.videos!r}")
    os.makedirs(args.outdir, exist_ok=True)
    if args.compile_cache:  # before anything builds the kernels
        enable_compile_cache(args.compile_cache)
    device = resolve_device(args.device)

    exported = None
    if args.from_export:
        try:
            exported = ExportedScorer(args.from_export, device)
        except (OSError, ValueError) as exc:
            raise SystemExit(f"--from-export: {exc}")
        want_crops = 10 if args.crops == "ten" else 1
        if exported.n_crops != want_crops:
            raise SystemExit(f"--from-export: this artifact was exported for {exported.n_crops} "
                             f"crops per clip but --crops {args.crops} extracts {want_crops}; "
                             "re-export with the matching --crops")
    stream = args.stream
    if stream is None and exported is not None:
        stream = exported.stream
    if stream is None and args.checkpoint:
        # a data.stream=both run is scored two-stream with no flag
        stream = ((TopKCheckpointer.load_metadata(args.checkpoint) or {}).get("data")
                  or {}).get("stream")
    stream = stream or "rgb"
    extracted_dim = 2 * FEATURE_DIM if stream == "both" else FEATURE_DIM
    # the scorer first: its path and weights checks fail before the extractor is built
    if exported is not None:
        scorer, model_name, scorer_dim = exported, exported.model_name, exported.channels
    else:
        scorer, model_name = build_scorer(args)
        scorer_dim = getattr(getattr(scorer, "config", None), "channels", extracted_dim)
    # --export never extracts: any width exports (the manifest records it)
    if scorer_dim != extracted_dim and not args.export:
        if stream == "both":
            hint = f"retrain with data.stream=both or pass --model-config channels={extracted_dim}"
        elif scorer_dim == 2 * FEATURE_DIM:
            hint = "pass --stream both (this scorer was trained on concatenated RGB+flow features)"
        else:
            hint = f"pass --model-config channels={extracted_dim}"
        raise SystemExit(f"--stream {stream} extracts {extracted_dim}-d features but the "
                         f"{model_name} scorer expects {scorer_dim}-d input; {hint}")
    if args.export:
        write_export(args, scorer, model_name, scorer_dim, stream)
        return 0

    # one weight tree for both streams: the flow stem adapts from it
    state_dict = load_i3d_weights(args.i3d_weights, args.i3d_model) if args.i3d_weights else None

    devices = None
    if args.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]

    def make_extractor(s: str) -> FeatureExtractor:
        return FeatureExtractor(
            model_name=args.i3d_model,
            state_dict=state_dict,
            frames_per_clip=args.frames_per_clip,
            adaptive_groups=args.group_mode == "adaptive",
            device=device,
            devices=devices,
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

    def process(path: str) -> dict:
        return process_video(path, extractor, scorer, args.outdir, model_name, args.threshold,
                             args.min_event_frames, args.features_dir, flow_extractor)

    if args.serve is not None:
        serve_http(args, process, on_ready)
        return 0
    if args.watch:
        watch_videos(args, process)
        return 0
    # score JSONs are stem-keyed: same-stem videos of different subfolders would collide
    warn_duplicate_stems(videos, what="scored")
    for path in videos:
        try:
            process(path)
        except ValueError as exc:
            # an undecodable file, or a video over the largest exported
            # bucket: a user problem, not a traceback
            raise SystemExit(f"{path}: {exc}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
