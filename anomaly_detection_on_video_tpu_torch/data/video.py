"""Video discovery and host video decode (counterpart of the JAX
package's ``data/video.py`` and its CLIs' ``find_videos`` and
``warn_duplicate_stems``).

Decode runs on the host: the native engine (``data/framepipe.py``, C++ over
FFmpeg) where it builds, else OpenCV. ``cv2`` is imported only inside the
decode functions: the rest of the port runs on hosts without it. Chunks are
3,008 frames (16 * 188), the reference's chunk size, so per-chunk feature
caches stay layout-compatible; videos over 1 GB (``is_large_video``, the
reference's rule) get such caches.
"""

from __future__ import annotations

import glob
import hashlib
import os
import queue
import sys
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

CHUNK_FRAMES = 16 * 188
LARGE_VIDEO_KB = 1024 ** 2  # 1 GB in KB (the reference's size test counts KB)
VIDEO_EXTENSIONS = (".mp4", ".avi", ".mkv", ".mov", ".webm", ".mpg", ".mpeg")


def find_videos(spec: str) -> List[str]:
    """The videos ``spec`` names, sorted: a directory is searched
    recursively, by extension and case-insensitively (corpora arrive in
    class subfolders, the UCF-Crime layout); an existing file is itself,
    even when its name holds glob characters; anything else is a glob.
    Empty when nothing matches; each CLI says so in its own words."""
    if os.path.isdir(spec):
        return sorted(path for path in glob.glob(os.path.join(spec, "**", "*"), recursive=True)
                      if path.lower().endswith(VIDEO_EXTENSIONS))
    if os.path.isfile(spec):
        return [spec]
    return sorted(glob.glob(spec))


def warn_duplicate_stems(paths: Sequence[str], what: str = "extracted") -> Dict[str, List[str]]:
    """Warn on stderr when videos from different folders share a filename
    stem: every output file is keyed by stem, so of such videos only the
    first is ``what`` (extracted, scored) and the rest are skipped as done.
    Returns the duplicated stems and their paths."""
    by_stem: Dict[str, List[str]] = {}
    for path in paths:
        by_stem.setdefault(os.path.splitext(os.path.basename(path))[0], []).append(path)
    dups = {stem: group for stem, group in by_stem.items() if len(group) > 1}
    for stem, group in sorted(dups.items()):
        print(f"warning: {len(group)} videos share the stem {stem!r} ({', '.join(group)}); "
              f"outputs are stem-keyed, so only the first will be {what}", file=sys.stderr)
    return dups


def _open(path: str):
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video {path!r}")
    return cv2, cap


def _decord_frames(path: str, start: int, count: Optional[int]) -> np.ndarray:
    """The reference's decode: ``decord.VideoReader`` read in order, RGB as
    it comes. decord is optional (imported here only, and not installed
    with the port); where it is, it gives the byte stream the published
    feature zips were extracted from."""
    import decord

    vr = decord.VideoReader(uri=path)
    stop = len(vr) if count is None else min(len(vr), start + count)
    frames = [np.asarray(vr[i].asnumpy()) for i in range(start, stop)]
    if not frames:
        raise ValueError(f"no frames decoded from {path!r} at start={start}")
    return np.stack(frames)


def decode_video_frames(path: str, start: int = 0, count: Optional[int] = None,
                        backend: str = "cv2") -> np.ndarray:
    """Decode frames [start, start+count) to RGB uint8 (N, H, W, 3).

    ``backend`` is ``"cv2"`` (OpenCV, the port's decoder) or ``"decord"``
    (the reference's, which must be installed): a decode difference can be
    told from a model difference by running both."""
    if backend == "decord":
        return _decord_frames(path, start, count)
    if backend != "cv2":
        raise ValueError(f"unknown decode backend {backend!r}")
    cv2, cap = _open(path)
    try:
        if start:
            cap.set(cv2.CAP_PROP_POS_FRAMES, start)
        frames = []
        while count is None or len(frames) < count:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path!r} at start={start}")
    return np.stack(frames)


def iter_decoded_chunks(path: str, chunk_frames: int = CHUNK_FRAMES) -> Iterator[np.ndarray]:
    """Stream a video as sequential RGB chunks without seeking."""
    cv2, cap = _open(path)
    try:
        chunk = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            chunk.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            if len(chunk) == chunk_frames:
                yield np.stack(chunk)
                chunk = []
        if chunk:
            yield np.stack(chunk)
    finally:
        cap.release()


class VideoFrameSource:
    """Chunked decoder that decodes up to ``depth`` chunks ahead of the
    consumer, so host decode of chunk N+1 overlaps device work on chunk N.

    The native engine (``framepipe.NativeFrameSource``, its own decode
    thread and ring) is used where it is available, else one Python thread
    over OpenCV. ``native=True`` raises where the engine is unavailable or
    cannot open the file; ``native=False`` always takes OpenCV. Decode
    errors re-raise in the consumer. ``close()`` (also run when iteration
    ends or is abandoned) stops the decode thread, which never stays
    blocked on a full queue.
    """

    def __init__(self, path: str, chunk_frames: int = CHUNK_FRAMES, depth: int = 2,
                 native: Optional[bool] = None):
        self.path = path
        self._native = None
        self._thread = None
        self._stop = threading.Event()
        if native is not False:
            from .framepipe import NativeFrameSource

            try:
                self._native = NativeFrameSource(path, chunk_frames, depth)
                return
            except (RuntimeError, FileNotFoundError):
                if native is True:
                    raise
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._worker, args=(chunk_frames,),
                                        name="frame-decode", daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up once the source is closed."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self, chunk_frames: int) -> None:
        chunks = iter_decoded_chunks(self.path, chunk_frames)
        try:
            for chunk in chunks:
                if not self._put(chunk):
                    return
            self._put(None)
        except BaseException as exc:  # handed to the consumer, which raises it
            self._put(exc)
        finally:
            chunks.close()

    def __iter__(self) -> Iterator[np.ndarray]:
        try:
            if self._native is not None:
                yield from self._native
                return
            while True:
                item = self._queue.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            self.close()

    def close(self) -> None:
        """Stop decoding and release the decoder; idempotent."""
        self._stop.set()
        if self._native is not None:
            self._native.close()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)


def video_num_frames(path: str) -> int:
    """The container's frame count (OpenCV's ``CAP_PROP_FRAME_COUNT``)."""
    cv2, cap = _open(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def is_large_video(path: str, threshold_kb: int = LARGE_VIDEO_KB) -> bool:
    """The reference's chunk-cache rule: the file's size in KB exceeds
    1024 ** 2 (1 GB)."""
    return os.path.getsize(path) / 1024 > threshold_kb


def decode_provenance(path: str, backend: str = "cv2", chunk_frames: int = CHUNK_FRAMES,
                      max_frames: Optional[int] = None) -> dict:
    """Decode fingerprint: frame counts and per-chunk RGB checksums.

    Two reports whose ``chunk_sha256`` lists match decoded byte-identically;
    a mismatch names the first chunk that differs, which tells a decode
    difference from a model difference. ``backend`` is ``"cv2"`` or
    ``"decord"`` (the reference's decoder; imported only here, and not
    installed with the port). Frames stream sequentially without seeks.
    Returns {backend, chunk_frames, container_frame_count, fps,
    decoded_frame_count, frame_shape, chunk_sha256, sha256}.
    """
    meta: dict = {"backend": backend, "chunk_frames": int(chunk_frames)}
    if backend == "cv2":
        cv2, cap = _open(path)
        try:
            meta["container_frame_count"] = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            meta["fps"] = float(cap.get(cv2.CAP_PROP_FPS))
        finally:
            cap.release()
        chunk_iter = iter_decoded_chunks(path, chunk_frames)
    elif backend == "decord":
        import decord  # the reference's decoder; its absence raises here

        vr = decord.VideoReader(uri=path)
        meta["container_frame_count"] = len(vr)
        meta["fps"] = float(getattr(vr, "get_avg_fps", lambda: 0.0)())
        chunk_iter = (np.stack([np.asarray(vr[i].asnumpy())
                                for i in range(lo, min(lo + chunk_frames, len(vr)))])
                      for lo in range(0, len(vr), chunk_frames))
    else:
        raise ValueError(f"unknown decode backend {backend!r}")
    total = hashlib.sha256()
    chunks: List[str] = []
    decoded = 0
    shape = None
    for chunk in chunk_iter:
        if max_frames is not None and decoded + len(chunk) > max_frames:
            chunk = chunk[: max_frames - decoded]
        if not len(chunk):
            break
        shape = tuple(chunk.shape[1:])
        data = np.ascontiguousarray(chunk).tobytes()
        chunks.append(hashlib.sha256(data).hexdigest())
        total.update(data)
        decoded += len(chunk)
        if max_frames is not None and decoded >= max_frames:
            break
    meta["decoded_frame_count"] = decoded
    meta["frame_shape"] = list(shape) if shape else None
    meta["chunk_sha256"] = chunks
    meta["sha256"] = total.hexdigest()
    return meta


class TenCropVideoFrameDataset:
    """The reference's per-clip dataset (``src/dataset.py:145-195``):
    indexable clips of one video, each preprocessed to its ten crops. The
    extractor processes whole frame stacks instead; this class serves
    per-clip code. It decodes eagerly, as the reference does.

    Items are float32 numpy arrays, channels last, ``(10, frames_per_clip,
    cropsize, cropsize, 3)``, as the JAX package's (the reference's are
    channels first).
    """

    def __init__(self, video_path_or_frames, frames_per_clip: int = 16, resize: int = 256,
                 cropsize: int = 224):
        if isinstance(video_path_or_frames, str):
            frames = decode_video_frames(video_path_or_frames)
        else:
            frames = np.asarray(video_path_or_frames)
            if frames.dtype != np.uint8 or frames.ndim != 4:
                raise ValueError("expected a video path or a uint8 (frames, H, W, 3) array")
        self.frames = frames
        self.frames_per_clip = frames_per_clip
        self.resize = resize
        self.cropsize = cropsize
        self._n_clips = (frames.shape[0] - 1) // frames_per_clip + 1

    def __len__(self) -> int:
        return self._n_clips

    def __getitem__(self, idx: int) -> np.ndarray:
        from ..ops.gtransforms import preprocess_frames

        if not 0 <= idx < self._n_clips:
            raise IndexError(idx)
        fpc = self.frames_per_clip
        clip = self.frames[idx * fpc: (idx + 1) * fpc]
        return preprocess_frames(clip, self.resize, self.cropsize, fpc)[0].numpy()
