"""ctypes binding to the repository's native decode engine,
``native/framepipe`` (counterpart of the JAX package's
``data/framepipe.py``).

framepipe is C++ over FFmpeg: a background thread decodes RGB24 chunks
into a bounded ring, so host decode overlaps device work. The library is
built with ``make`` in ``native/framepipe`` at first use (about a second)
when it is not there yet; on a host without FFmpeg's development files
that build fails, ``available()`` is False, and ``data/video.py``'s
``VideoFrameSource`` decodes with OpenCV instead. Nothing is built or
loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native" / "framepipe"
LIB_PATH = NATIVE_DIR / "libframepipe.so"

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _load_library() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if missing; None where it cannot
    be built or loaded (tried once per process)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not LIB_PATH.exists():
            try:
                subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True,
                               capture_output=True, timeout=120)
            except (subprocess.SubprocessError, FileNotFoundError):
                return None
        try:
            lib = ctypes.CDLL(str(LIB_PATH))
        except OSError:
            return None
        lib.fp_stream_open.restype = ctypes.c_void_p
        lib.fp_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.fp_stream_width.restype = ctypes.c_int
        lib.fp_stream_width.argtypes = [ctypes.c_void_p]
        lib.fp_stream_height.restype = ctypes.c_int
        lib.fp_stream_height.argtypes = [ctypes.c_void_p]
        lib.fp_stream_fps.restype = ctypes.c_double
        lib.fp_stream_fps.argtypes = [ctypes.c_void_p]
        lib.fp_stream_approx_frames.restype = ctypes.c_int64
        lib.fp_stream_approx_frames.argtypes = [ctypes.c_void_p]
        lib.fp_stream_next.restype = ctypes.c_int
        lib.fp_stream_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.fp_stream_error.restype = ctypes.c_char_p
        lib.fp_stream_error.argtypes = [ctypes.c_void_p]
        lib.fp_stream_close.restype = None
        lib.fp_stream_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native engine can decode on this host."""
    return _load_library() is not None


class NativeFrameSource:
    """Iterator of RGB uint8 ``(n, H, W, 3)`` chunks of ``chunk_frames``
    frames (the last one shorter) decoded by the native engine, which
    decodes up to ``depth`` chunks ahead. Raises RuntimeError where the
    engine is unavailable and FileNotFoundError where it cannot open
    ``path``."""

    def __init__(self, path: str, chunk_frames: int, depth: int = 2):
        lib = _load_library()
        if lib is None:
            raise RuntimeError("framepipe native library unavailable")
        self._lib = lib
        self._handle = lib.fp_stream_open(path.encode(), int(chunk_frames), int(depth))
        if not self._handle:
            raise FileNotFoundError(f"framepipe cannot open {path!r}")
        self.chunk_frames = chunk_frames
        self.width = lib.fp_stream_width(self._handle)
        self.height = lib.fp_stream_height(self._handle)
        self.fps = lib.fp_stream_fps(self._handle)

    def __iter__(self) -> Iterator[np.ndarray]:
        buf = np.empty((self.chunk_frames, self.height, self.width, 3), np.uint8)
        while True:
            if not self._handle:
                return
            n = self._lib.fp_stream_next(self._handle, buf.ctypes.data_as(ctypes.c_void_p))
            if n == 0:
                return
            if n < 0:
                raise RuntimeError(
                    "framepipe decode error: " + self._lib.fp_stream_error(self._handle).decode())
            yield buf[:n].copy()

    def close(self) -> None:
        """Stop the decode thread and free the stream; idempotent."""
        if getattr(self, "_handle", None):
            self._lib.fp_stream_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
