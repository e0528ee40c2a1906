"""Zstandard compression and decompression through the system's
``libzstd.so.1``.

The JAX package's orbax checkpoints compress their b-tree nodes, manifests
and array chunks with zstd (``training/orbax.py`` reads and writes them).
The port binds the C library with ``ctypes`` the first time a frame is
made or read, and uses no Python zstd package:

- ``compress`` writes one frame with ``ZSTD_compress`` into a buffer of
  ``ZSTD_compressBound`` bytes; the frame records its content size;
- a frame that records its content size goes through ``ZSTD_decompress``
  into a buffer of exactly that size;
- a frame that does not (a streaming writer's) goes through the streaming
  API (``ZSTD_decompressStream``), one output block at a time.

Where the library is missing, both raise ``OSError`` naming it; there is
no second route.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Union

import numpy as np

LIBRARY = "libzstd.so.1"
MAGIC = b"\x28\xb5\x2f\xfd"
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def library() -> ctypes.CDLL:
    """The bound ``libzstd.so.1`` (loaded and typed once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                lib = ctypes.CDLL(LIBRARY)
            except OSError:
                raise OSError(f"zstd: the system library {LIBRARY} is not installed; "
                              "reading and writing orbax checkpoints need it (Debian/Ubuntu "
                              "package libzstd1)") from None
            size_t, void_p = ctypes.c_size_t, ctypes.c_void_p
            lib.ZSTD_getFrameContentSize.argtypes = [void_p, size_t]
            lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
            lib.ZSTD_decompress.argtypes = [void_p, size_t, void_p, size_t]
            lib.ZSTD_decompress.restype = size_t
            lib.ZSTD_isError.argtypes = [size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_getErrorName.argtypes = [size_t]
            lib.ZSTD_getErrorName.restype = ctypes.c_char_p
            lib.ZSTD_createDStream.argtypes = []
            lib.ZSTD_createDStream.restype = void_p
            lib.ZSTD_freeDStream.argtypes = [void_p]
            lib.ZSTD_freeDStream.restype = size_t
            lib.ZSTD_initDStream.argtypes = [void_p]
            lib.ZSTD_initDStream.restype = size_t
            lib.ZSTD_DStreamOutSize.argtypes = []
            lib.ZSTD_DStreamOutSize.restype = size_t
            lib.ZSTD_decompressStream.argtypes = [void_p, ctypes.POINTER(_OutBuffer),
                                                  ctypes.POINTER(_InBuffer)]
            lib.ZSTD_decompressStream.restype = size_t
            lib.ZSTD_compressBound.argtypes = [size_t]
            lib.ZSTD_compressBound.restype = size_t
            lib.ZSTD_compress.argtypes = [void_p, size_t, void_p, size_t, ctypes.c_int]
            lib.ZSTD_compress.restype = size_t
            _lib = lib
        return _lib


def _check(lib: ctypes.CDLL, code: int) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def compress(data: Union[bytes, bytearray, memoryview, np.ndarray], level: int = 3) -> bytes:
    """One zstd frame holding ``data`` (any C-contiguous buffer, read in
    place), compressed at ``level`` (0: the library's default, 3). The
    frame records its content size, as ``zstandard``'s do by default."""
    lib = library()
    src = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    if not src.flags.c_contiguous:
        raise ValueError("zstd: compress takes a C-contiguous buffer")
    size = src.nbytes
    out = np.empty(max(int(lib.ZSTD_compressBound(size)), 1), np.uint8)
    n = _check(lib, lib.ZSTD_compress(out.ctypes.data, out.size, src.ctypes.data if size else None,
                                      size, int(level)))
    return out[:n].tobytes()


def decompress(frame: bytes) -> bytes:
    """The content of one zstd frame (several concatenated frames decode
    to their contents joined, as the C library decodes them). A corrupt or
    truncated frame raises ValueError."""
    lib = library()
    frame = bytes(frame)
    if not frame.startswith(MAGIC):
        raise ValueError("zstd: not a zstd frame (bad magic number)")
    size = lib.ZSTD_getFrameContentSize(frame, len(frame))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("zstd: the frame header is corrupt")
    if size != _CONTENTSIZE_UNKNOWN:
        out = ctypes.create_string_buffer(max(int(size), 1))
        n = _check(lib, lib.ZSTD_decompress(out, int(size), frame, len(frame)))
        return out.raw[:n]
    return _decompress_stream(lib, frame)


def _decompress_stream(lib: ctypes.CDLL, frame: bytes) -> bytes:
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("zstd: ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(stream))
        block = int(lib.ZSTD_DStreamOutSize())
        out = ctypes.create_string_buffer(block)
        src = ctypes.create_string_buffer(frame, len(frame))
        inbuf = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(frame), 0)
        parts = []
        while True:
            outbuf = _OutBuffer(ctypes.cast(out, ctypes.c_void_p), block, 0)
            remaining = _check(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(outbuf),
                                                              ctypes.byref(inbuf)))
            parts.append(out.raw[:outbuf.pos])
            # 0: a frame is decoded and flushed (another may follow); the
            # decoder may also have taken all the input into its own buffer
            # and still owe output, so only a call with nothing in and
            # nothing out ends an unfinished frame
            if remaining == 0 and inbuf.pos == inbuf.size:
                return b"".join(parts)
            if remaining != 0 and inbuf.pos == inbuf.size and outbuf.pos == 0:
                raise ValueError("zstd: the frame is truncated")
    finally:
        lib.ZSTD_freeDStream(stream)
