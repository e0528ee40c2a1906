"""Host video decode with OpenCV (counterpart of the JAX package's
``data/video.py`` cv2 backend).

``cv2`` is imported only inside the decode functions: the rest of the port
runs on hosts without it. Chunks are 3,008 frames (16 * 188), the
reference's chunk size, so per-chunk features stay layout-compatible.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

CHUNK_FRAMES = 16 * 188


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
