"""Video discovery and host video decode with OpenCV (counterpart of the
JAX package's ``data/video.py`` cv2 backend and its CLIs' ``find_videos``
and ``warn_duplicate_stems``).

``cv2`` is imported only inside the decode functions: the rest of the port
runs on hosts without it. Chunks are 3,008 frames (16 * 188), the
reference's chunk size, so per-chunk features stay layout-compatible.
"""

from __future__ import annotations

import glob
import os
import queue
import sys
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

CHUNK_FRAMES = 16 * 188
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


def decode_video_frames(path: str, start: int = 0, count: Optional[int] = None) -> np.ndarray:
    """Decode frames [start, start+count) to RGB uint8 (N, H, W, 3)."""
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
    """Chunked decoder with one worker thread decoding ahead of the
    consumer, so host decode of chunk N+1 overlaps device work on chunk N."""

    def __init__(self, path: str, chunk_frames: int = CHUNK_FRAMES, depth: int = 2):
        self.path = path
        self._queue: "queue.Queue" = queue.Queue(maxsize=depth)
        self._thread = threading.Thread(target=self._worker, args=(chunk_frames,), daemon=True)
        self._thread.start()

    def _worker(self, chunk_frames: int) -> None:
        try:
            for chunk in iter_decoded_chunks(self.path, chunk_frames):
                self._queue.put(chunk)
            self._queue.put(None)
        except BaseException as exc:  # handed to the consumer, which raises it
            self._queue.put(exc)

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            item = self._queue.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
