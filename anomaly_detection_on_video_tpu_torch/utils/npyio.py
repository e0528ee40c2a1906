"""Atomic writes (counterpart of the JAX package's ``utils/npyio.py``
``atomic_write_bytes`` and ``atomic_save``): resuming by file existence
stays safe when a run is interrupted mid-write."""

from __future__ import annotations

import os
import tempfile
from typing import BinaryIO, Callable

import numpy as np


def _atomic_write(path: str, suffix: str, write: Callable[[BinaryIO], None]) -> None:
    """``write`` into a temporary file in ``path``'s directory, then rename
    it over ``path``, so an interrupted run never leaves a truncated file."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def atomic_write_bytes(path: str, blob: bytes) -> None:
    """Write ``blob`` to ``path`` through a temporary file and a rename."""
    _atomic_write(path, ".tmp", lambda f: f.write(blob))


def atomic_save(path: str, array: np.ndarray) -> None:
    """``np.save`` through a temporary file in the same directory and a
    rename, so an interrupted run never leaves a truncated ``.npy``."""
    _atomic_write(path, ".tmp.npy", lambda f: np.save(f, array))
