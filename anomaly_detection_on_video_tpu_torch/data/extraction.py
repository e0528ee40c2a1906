"""I3D feature extraction for the RGB stream: ten crops or the center crop,
serial or with a pool of decode threads.

Counterpart of the JAX package's ``data/extraction.py``: ``FeatureExtractor``
(``pad_frames``, ``_group_for``, ``dispatch_frames`` /
``materialize_features``, ``extract_video`` with per-chunk caches, the
resize -> crop -> forward pipeline), ``extract_videos`` and
``extract_videos_pooled``. Frames are loop-padded on the host so every clip
is a contiguous run of frames, resized on the device, then each group of
clips goes through kernel K1 (ten-crop + standardize) or, for center crops,
``center_crop`` + ``standardize`` as torch ops (the JAX package runs them
through XLA), and the i3res50 forward (kernels K2 and K3). The JAX
package's ``lax.map`` over groups is a Python loop here. Output:
``(n_clips, 10, 2048)`` float32, the reference's on-disk feature contract,
or ``(n_clips, 1, 2048)`` for center crops (the serving protocol).

``quantize=True`` is the int8 extractor (the JAX package's
``FeatureExtractor(quantize=True)``): the first chunk calibrates static
per-conv activation scales (``_calibrate``), then every conv runs in int8
through kernels K4 and K5. ``pin_calibration`` keeps one set of scales per
feature directory in ``act_scales_rgb.json``, the JAX package's sidecar
name and format, so either package resumes the other's directory.

Threads: the device work of ``dispatch_frames`` runs on one worker thread
per extractor, so the caller decodes and pads the next chunk meanwhile;
``extract_frames`` (a request, with nothing to overlap) runs the same work
on the caller's thread once the worker is idle, so one thread at a time
launches the extractor's kernels. Grad mode is per thread, so the device
work enters ``torch.no_grad`` itself; it launches on its thread's current
stream and copies the features to the host there, so the copy waits for
that stream's work. int8 calibration runs on the caller's thread before
the first dispatch. The flow stream (``flow_extractor=``) is not ported.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue as queue_mod
import threading
from concurrent.futures import Future, ThreadPoolExecutor, wait
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..models import seeded_init_
from ..models.i3d import build_i3d_feature_extractor, calibrate_act_scales
from ..ops.gtransforms import center_crop, loop_pad_indices, standardize, ten_crop
from ..ops.kernels.crop_norm import ten_crop_standardize
from ..ops.resize import resize_bilinear_exact, resize_bilinear_fast, short_side_size
from ..utils.device import DeviceLike, resolve_device
from ..utils.npyio import atomic_save
from .video import CHUNK_FRAMES, VideoFrameSource, is_large_video

# the JAX package's sidecar of int8 scales for the RGB stream
CALIBRATION_FILE = "act_scales_rgb.json"
# decoded chunks waiting for the device in extract_videos_pooled: bounds
# the host memory of raw frames (a 3,008-frame 240x320 chunk is 0.7 GB)
QUEUE_CHUNKS = 3


class FeatureExtractor:
    """RGB I3D extractor, ten crops (the reference protocol) or the center
    crop (``crops="center"``, the serving protocol: exactly ten-crop row 4).

    ``batch`` bounds the (clip, crop) forwards per step: ten-crop clips go
    in groups of ``batch // 10``; center-crop clips in groups of
    ``batch // 4`` (the JAX package's rule, a quarter of the padding of
    ``batch`` clips), the last group padded with copies of the final clip
    whose results are dropped. ``model`` replaces the named model (tests
    pass a narrow ``I3DResNet``); without ``state_dict`` the weights are
    random from ``seed``. float32 runs are parity runs and take the exact
    PIL resize; bfloat16 runs take the float resize (bfloat16 convs already
    break bit-parity). ``quantize`` runs the convs in int8, computing in
    ``dtype`` around them, with scales calibrated on the first chunk
    unless ``pin_calibration`` loads them.
    """

    def __init__(
        self,
        model_name: str = "tushar-n-baseline",
        state_dict: Optional[dict] = None,
        dtype: torch.dtype = torch.bfloat16,
        batch: int = 240,
        frames_per_clip: int = 16,
        resize: int = 256,
        cropsize: int = 224,
        adaptive_groups: bool = False,
        device: DeviceLike = "cuda",
        model: Optional[nn.Module] = None,
        seed: int = 0,
        quantize: bool = False,
        crops: str = "ten",
    ):
        if crops not in ("ten", "center"):
            raise ValueError(f"crops must be ten or center, got {crops!r}")
        self.device = resolve_device(device)
        if model is None:
            model = build_i3d_feature_extractor(model_name, dtype=dtype)
        model.dtype = dtype
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            seeded_init_(model, seed)
        self.model = model.to(self.device).eval()
        self.dtype = dtype
        self.crops = crops
        self.n_crops = 10 if crops == "ten" else 1
        # center crops: batch // 4 clips per group, the JAX package's knee
        # between padding a short video and filling the device
        self.group_clips = max(1, batch // (4 if crops == "center" else self.n_crops))
        self.adaptive_groups = adaptive_groups
        self.frames_per_clip = frames_per_clip
        self.resize = resize
        self.cropsize = cropsize
        self.quantize = quantize
        self._calibration_path: Optional[str] = None  # set by pin_calibration
        self._dispatch_pool: Optional[ThreadPoolExecutor] = None  # dispatch_frames' worker
        self._last_dispatch: Optional[Future] = None  # the worker's newest job

    @property
    def _needs_calibration(self) -> bool:
        return self.quantize and self.model.act_scales is None

    def _group_for(self, n_clips: int) -> int:
        """Clips per group: always ``group_clips`` in fixed mode; in
        adaptive (serving) mode the smallest power of two that holds the
        request, capped at ``group_clips``."""
        if not self.adaptive_groups or n_clips >= self.group_clips:
            return self.group_clips
        rung = 1 << max(0, n_clips - 1).bit_length()
        return min(rung, self.group_clips)

    def pad_frames(self, frames: np.ndarray, group_clips: Optional[int] = None) -> np.ndarray:
        """Host loop-pad + group-pad of the raw uint8 frames: a short tail
        clip repeats its own frames (tail[i % L]); the last group fills
        with copies of the final clip."""
        fpc = self.frames_per_clip
        gc = group_clips or self.group_clips
        n_frames = frames.shape[0]
        n_clips = (n_frames - 1) // fpc + 1
        tail = n_frames - (n_clips - 1) * fpc
        if tail != fpc:
            tail_frames = frames[(n_clips - 1) * fpc:]
            reps = -(-fpc // tail)
            pad = np.tile(tail_frames, (reps, 1, 1, 1))[: fpc - tail]
            frames = np.concatenate([frames, pad])
        missing = -(-n_clips // gc) * gc - n_clips
        if missing:
            last_clip = frames[-fpc:]
            frames = np.concatenate([frames] + [last_clip] * missing)
        return frames

    def extract_frames(self, frames: np.ndarray) -> np.ndarray:
        """uint8 (n_frames, H, W, 3) -> float32 (n_clips, n_crops, C).

        The same work and result as ``materialize_features(dispatch_frames(
        frames))``, run on this thread: a single call has nothing to
        overlap, so it skips the hop to the worker. It first waits for the
        worker to finish what was dispatched before, so one thread at a
        time launches.
        """
        padded, gc, n_clips = self._prepare(frames)
        if self._last_dispatch is not None:
            wait([self._last_dispatch])
        return self._extract(padded, gc, n_clips)

    def dispatch_frames(self, frames: np.ndarray) -> Tuple[Future, int]:
        """Start extracting ``frames`` without waiting for the result.

        Calibrates first where int8 still needs it (on this thread), pads
        the frames, and hands the device work to the extractor's one worker
        thread, which copies the frames in, runs every group and copies the
        features out. The caller meanwhile decodes and pads the next chunk.
        Order is preserved (one worker). Returns a handle for
        ``materialize_features``.
        """
        padded, gc, n_clips = self._prepare(frames)
        if self._dispatch_pool is None:
            # a new thread's OpenMP team defaults to every core: give the
            # worker the caller's intra-op thread count
            self._dispatch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="extract-dispatch",
                initializer=torch.set_num_threads, initargs=(torch.get_num_threads(),))
        self._last_dispatch = self._dispatch_pool.submit(self._extract, padded, gc, n_clips)
        return self._last_dispatch, n_clips

    def _prepare(self, frames: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """Calibrate where int8 still needs it, then pad: -> (padded
        frames, clips per group, clips)."""
        if self._needs_calibration:
            self._calibrate(frames)
        n_clips = (frames.shape[0] - 1) // self.frames_per_clip + 1
        gc = self._group_for(n_clips)
        return self.pad_frames(frames, gc), gc, n_clips

    @staticmethod
    def materialize_features(dispatched: Tuple[Future, int]) -> np.ndarray:
        """Wait for a ``dispatch_frames`` handle -> (n_clips, n_crops, C)
        float32; an error of the device work raises here."""
        future, _ = dispatched
        return future.result()

    def _extract(self, padded: np.ndarray, gc: int, n_clips: int) -> np.ndarray:
        """The device work of one call: copy in, resize, crop, forward per
        group, copy the first ``n_clips`` clips' features out."""
        with torch.no_grad():  # grad mode is per thread
            fpc = self.frames_per_clip
            frames = torch.from_numpy(np.ascontiguousarray(padded)).to(self.device)
            out_h, out_w = short_side_size(frames.shape[1], frames.shape[2], self.resize)
            resize_fn = (resize_bilinear_exact if self.dtype == torch.float32
                         else resize_bilinear_fast)
            resized = resize_fn(frames, out_h, out_w).contiguous()  # uint8 on the device
            feats = []
            for group in resized.reshape(-1, gc, fpc, out_h, out_w, 3):
                if self.n_crops == 1:
                    crop = center_crop(group, self.cropsize)
                    x = standardize(crop).to(self.dtype).contiguous()
                else:
                    x = ten_crop_standardize(group, self.cropsize, self.dtype)  # K1
                feats.append(self.model(x).reshape(gc, self.n_crops, -1))
            out = torch.cat(feats)[:n_clips]
            return out.to(torch.float32).cpu().numpy()

    def extract_video(self, video_path: str, chunk_frames: int = CHUNK_FRAMES,
                      cache_dir: Optional[str] = None, timer=None) -> np.ndarray:
        """Whole-video extraction over decoded chunks, one deep: chunk N is
        dispatched before chunk N-1's features are waited for, so N's copy
        and forward overlap N-1's readback and the next decode.

        ``cache_dir`` keeps each chunk's features in
        ``chunk_cache_path(cache_dir, video_path, i)`` and reuses the
        chunks found there (resuming an interrupted large video).
        ``timer``: a ``utils.profiling.StageTimer``, given the stages
        ``decode_wait`` and ``device_extract``.
        """
        stage = timer.stage if timer is not None else _null_stage
        outputs: list = []
        pending = None  # (output index, dispatch handle, cache path or None)

        def resolve(entry) -> None:
            """Wait for an in-flight chunk's features and store them."""
            if entry is None:
                return
            idx, dispatched, chunk_path = entry
            with stage("device_extract"):
                feats = self.materialize_features(dispatched)
            if chunk_path is not None:
                atomic_save(chunk_path, feats)
            outputs[idx] = feats

        source = VideoFrameSource(video_path, chunk_frames)
        try:
            chunks = iter(source)
            while True:
                with stage("decode_wait"):
                    chunk = next(chunks, None)
                if chunk is None:
                    break
                i = len(outputs)
                chunk_path = None
                if cache_dir is not None:
                    chunk_path = self.chunk_cache_path(cache_dir, video_path, i)
                    if os.path.exists(chunk_path):
                        resolve(pending)
                        pending = None
                        outputs.append(np.load(chunk_path))
                        continue
                outputs.append(None)
                prev = pending
                pending = (i, self.dispatch_frames(chunk), chunk_path)
                resolve(prev)
            resolve(pending)
        finally:
            source.close()
        if not outputs:
            raise ValueError(f"{video_path}: decoded zero frames (corrupt or empty video)")
        return np.vstack(outputs)

    def chunk_cache_path(self, cache_dir: str, video_path: str, index: int) -> str:
        """Per-chunk feature cache, the reference's layout:
        ``<cache_dir>/<stem>/<stem>_{index}.npy``."""
        stem = os.path.splitext(os.path.basename(video_path))[0]
        return os.path.join(cache_dir, stem, f"{stem}_{index}.npy")

    def _calibrate(self, frames: np.ndarray) -> None:
        """Calibrate the int8 activation scales on the first chunk.

        At most four clips of it go through the exact resize, the crops of
        this extractor's protocol (ten, or the center one) and the
        standardization, as the JAX package's calibration does, then one
        unquantized forward of the unfused chain records every conv
        input's range (``models.i3d.calibrate_act_scales``). Later chunks
        that exceed a calibrated range saturate.
        """
        n_frames = int(min(frames.shape[0], 4 * self.frames_per_clip))
        sample = torch.from_numpy(np.ascontiguousarray(frames[:n_frames])).to(self.device)
        out_h, out_w = short_side_size(sample.shape[1], sample.shape[2], self.resize)
        resized = resize_bilinear_exact(sample, out_h, out_w)
        if self.n_crops == 1:
            crops = center_crop(resized, self.cropsize)[None]
        else:
            crops = ten_crop(resized, self.cropsize)
        clip_idx = loop_pad_indices(n_frames, self.frames_per_clip).astype(np.int64)
        clips = standardize(crops[:, torch.from_numpy(clip_idx).to(self.device)])  # (n_crops, n, fpc, ...)
        batch = clips.reshape(-1, self.frames_per_clip, self.cropsize, self.cropsize, 3)
        self.model.act_scales = calibrate_act_scales(self.model, batch)
        if self._calibration_path is not None:
            _write_json(self._calibration_path, self.model.act_scales)

    def pin_calibration(self, outdir: str) -> None:
        """Pin the int8 scales to a feature directory.

        The first quantized run into ``outdir`` records its scales in
        ``act_scales_rgb.json``; later runs load them instead of
        calibrating on their own first chunk, so one directory holds one
        quantization. Scales applied before (calibrated elsewhere) are
        written here at once. No-op for a full-precision extractor.
        """
        if not self.quantize:
            return
        os.makedirs(outdir, exist_ok=True)
        self._calibration_path = os.path.join(outdir, CALIBRATION_FILE)
        if os.path.exists(self._calibration_path):
            with open(self._calibration_path) as f:
                self.model.act_scales = json.load(f)
        elif not self._needs_calibration:
            _write_json(self._calibration_path, self.model.act_scales)

    def ensure_calibrated(self, outdir: str, video_path: str,
                          chunk_frames: int = CHUNK_FRAMES) -> None:
        """Make sure ``outdir`` holds the scales sidecar: load it, or
        calibrate on the first chunk of ``video_path`` and write it, even
        when no video of the directory is left to extract. No-op for a
        full-precision extractor."""
        if not self.quantize:
            return
        self.pin_calibration(outdir)
        if not self._needs_calibration:
            return
        source = VideoFrameSource(video_path, chunk_frames)
        try:
            chunk = next(iter(source), None)
        finally:
            source.close()
        if chunk is None:
            raise ValueError(f"{video_path}: decoded zero frames (corrupt or empty video)")
        self._calibrate(chunk)


def _write_json(path: str, value) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(value, f)
    os.replace(tmp, path)


def _null_stage(name: str):
    return contextlib.nullcontext()


def _cached_chunk(extractor: FeatureExtractor, chunk: np.ndarray, path: str, index: int,
                  cache: Optional[str], stage=_null_stage) -> np.ndarray:
    """One chunk's features, serially, with the per-chunk cache: read from
    ``cache`` where the chunk is there, else extracted (and written there
    when ``cache`` is set). ``stage`` is a ``StageTimer.stage``-like
    context factory."""
    chunk_path = None
    if cache is not None:
        chunk_path = extractor.chunk_cache_path(cache, path, index)
        if os.path.exists(chunk_path):
            return np.load(chunk_path)
    with stage("device_extract"):
        feats = extractor.extract_frames(chunk)
    if chunk_path is not None:
        atomic_save(chunk_path, feats)
    return feats


def feature_filename(stem: str) -> str:
    """``<stem>_i3d.npy``, the reference's on-disk name for RGB features."""
    return f"{stem}_i3d.npy"


def record_crop_protocol(outdir: str, crops: str) -> None:
    """Pin the crop protocol of a feature directory in ``crops.json``, the
    JAX package's ``record_crop_protocol``.

    Ten-crop ``(n, 10, 2048)`` and center-crop ``(n, 1, 2048)`` features
    share filenames, so resuming a directory under the other protocol would
    mix them. A center-crop run pins ``{"crops": "center"}``; a ten-crop run
    writes nothing, and a directory with feature files but no pin is
    ten-crop. Raises when ``crops`` differs from the directory's protocol.
    """
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, "crops.json")
    previous = None
    if os.path.exists(path):
        with open(path) as f:
            previous = json.load(f).get("crops")
    elif any(name.endswith(("_i3d.npy", "_flow.npy")) for name in os.listdir(outdir)):
        previous = "ten"  # unpinned features predate the center protocol
    if previous is not None:
        if previous != crops:
            raise ValueError(
                f"{outdir} holds {previous}-crop features but this run uses crops={crops!r}; "
                f"the two protocols are shape-incompatible on disk ((n, 10, 2048) vs "
                f"(n, 1, 2048)). Pass crops={previous!r} to resume, or use a fresh outdir.")
        return
    if crops != "ten":
        print(f"crop protocol: {crops} (pinned in {path})")
        _write_json(path, {"crops": crops})


def _progress_bar(total: int, progress: bool):
    """A tqdm bar of ``total`` steps where tqdm is installed and
    ``progress`` is set, else None."""
    if progress:
        try:
            from tqdm.auto import tqdm

            return tqdm(total=total)
        except ImportError:
            pass
    return None


def extract_videos(video_paths: Sequence[str], outdir: str, extractor: FeatureExtractor,
                   chunk_cache_for_large: bool = True, progress: bool = True,
                   timer=None) -> int:
    """Extract every video into ``outdir/<stem>_i3d.npy``, one at a time,
    skipping those already on disk. Checks (and for center crops pins) the
    directory's crop protocol before anything is built or written, and
    pins the int8 scales to ``outdir``. Videos over 1 GB
    (``is_large_video``) keep per-chunk caches in ``outdir`` when
    ``chunk_cache_for_large``, so an interrupted run resumes them.
    ``timer`` is handed to ``extract_video``. Returns the number of videos
    extracted.
    """
    os.makedirs(outdir, exist_ok=True)
    record_crop_protocol(outdir, extractor.crops)
    extractor.pin_calibration(outdir)
    bar = _progress_bar(len(video_paths), progress)
    n_done = 0
    try:
        for path in video_paths:
            stem = os.path.splitext(os.path.basename(path))[0]
            savepath = os.path.join(outdir, feature_filename(stem))
            if not os.path.exists(savepath):
                cache = outdir if chunk_cache_for_large and is_large_video(path) else None
                atomic_save(savepath, extractor.extract_video(path, cache_dir=cache, timer=timer))
                n_done += 1
            if bar is not None:
                bar.update(1)
    finally:
        if bar is not None:
            bar.close()
    return n_done


def extract_videos_pooled(
    video_paths: Sequence[str],
    outdir: str,
    extractor: FeatureExtractor,
    flow_extractor=None,
    decode_workers: Optional[int] = None,
    chunk_frames: int = CHUNK_FRAMES,
    chunk_cache_for_large: bool = True,
    progress: bool = True,
) -> int:
    """Many videos, decoded by a pool of threads into one device queue.

    One decode stream cannot keep the device busy, so ``decode_workers``
    videos (default: one per core, at most 8) decode at once into a
    queue of ``QUEUE_CHUNKS`` chunks, which bounds the host memory of raw
    frames. This
    thread takes the chunks in arrival order and dispatches each, one deep
    as ``extract_video`` does; each video's file is assembled from its
    chunks in index order once its producer reports it done. Outputs, skip
    of existing files and per-chunk caches of large videos are those of
    ``extract_videos``: cached chunks are read back, not extracted, and
    stay on disk (as paths) until assembly. An error in a producer re-raises
    here; on any exit the producers' puts time out against a stop event,
    so no decode thread stays blocked. Returns the number of videos
    extracted.
    """
    if flow_extractor is not None:
        raise NotImplementedError(
            "the flow stream (two-stream pooled extraction) is not ported yet; it comes with "
            "the optical-flow module (ROADMAP.md, queue 1, module 6)")
    if decode_workers is None:
        decode_workers = min(8, os.cpu_count() or 1)
    os.makedirs(outdir, exist_ok=True)
    record_crop_protocol(outdir, extractor.crops)
    extractor.pin_calibration(outdir)

    def savepath_for(path: str) -> str:
        return os.path.join(outdir, feature_filename(os.path.splitext(os.path.basename(path))[0]))

    # videos whose file is missing; of videos that share a stem (and so a
    # file) only the first, as the serial path extracts only the first
    todo, claimed = [], set()
    for path in video_paths:
        savepath = savepath_for(path)
        if savepath not in claimed and not os.path.exists(savepath):
            claimed.add(savepath)
            todo.append((path, outdir if chunk_cache_for_large and is_large_video(path) else None))
    if not todo:
        return 0

    chunk_queue: "queue_mod.Queue" = queue_mod.Queue(maxsize=QUEUE_CHUNKS)
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up once the consumer has stopped."""
        while not stop.is_set():
            try:
                chunk_queue.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def producer(path: str, cache: Optional[str]) -> None:
        source = None
        try:
            source = VideoFrameSource(path, chunk_frames)
            index = -1
            for index, chunk in enumerate(source):
                cached = cache is not None and os.path.exists(
                    extractor.chunk_cache_path(cache, path, index))
                # a cached chunk is read back by the consumer: send no frames
                if not _put(("chunk", path, index, (cache, None if cached else chunk))):
                    return
            if index < 0:
                raise ValueError(f"{path}: decoded zero frames (corrupt or empty video)")
            _put(("done", path, index + 1, None))
        except BaseException as exc:  # re-raised by the consumer
            _put(("error", path, 0, exc))
        finally:
            if source is not None:
                source.close()

    pool = ThreadPoolExecutor(max_workers=max(1, decode_workers),
                              thread_name_prefix="decode-pool")
    for path, cache in todo:
        pool.submit(producer, path, cache)
    bar = _progress_bar(len(todo), progress)

    # per-video chunks in flight: cached ones as paths (features on disk),
    # the others as arrays, so host memory stays bounded for large videos
    partial: dict = {}
    totals: dict = {}
    pending = None  # the 1-deep device pipeline, as in extract_video

    def resolve(entry) -> None:
        if entry is None:
            return
        res_path, res_index, res_chunk_path, dispatched = entry
        feats = extractor.materialize_features(dispatched)
        if res_chunk_path is not None:
            atomic_save(res_chunk_path, feats)
            feats = res_chunk_path
        partial.setdefault(res_path, {})[res_index] = feats

    def assemble(path: str) -> bool:
        """Write the video's file if every chunk of it is in."""
        chunks = partial.get(path, {})
        if path not in totals or len(chunks) != totals[path]:
            return False
        feats = np.vstack([np.load(c) if isinstance(c, str) else c
                           for c in (chunks[i] for i in range(totals[path]))])
        atomic_save(savepath_for(path), feats)
        partial.pop(path, None)
        return True

    n_done = 0
    try:
        while n_done < len(todo):
            kind, path, index, payload = chunk_queue.get()
            if kind == "error":
                raise payload
            if kind == "chunk":
                cache, chunk = payload
                chunk_path = None if cache is None else extractor.chunk_cache_path(
                    cache, path, index)
                if chunk is None or (chunk_path is not None and os.path.exists(chunk_path)):
                    resolve(pending)
                    pending = None
                    partial.setdefault(path, {})[index] = chunk_path
                else:
                    # dispatch this chunk before waiting on the previous one
                    prev = pending
                    pending = (path, index, chunk_path, extractor.dispatch_frames(chunk))
                    resolve(prev)
            else:
                totals[path] = index
                # "done" follows all of a video's chunks: resolving here
                # lets its assembly below see every chunk
                resolve(pending)
                pending = None
            if assemble(path):
                n_done += 1
                if bar is not None:
                    bar.update(1)
    finally:
        stop.set()
        pool.shutdown(wait=True, cancel_futures=True)
        if bar is not None:
            bar.close()
    return n_done
