"""Atomic numpy writes (counterpart of the JAX package's
``utils/npyio.py`` ``atomic_save``): resuming by file existence stays safe
when a run is interrupted mid-write."""

from __future__ import annotations

import os
import tempfile

import numpy as np


def atomic_save(path: str, array: np.ndarray) -> None:
    """``np.save`` through a temporary file in the same directory and a
    rename, so an interrupted run never leaves a truncated ``.npy``."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npy")
    try:
        with os.fdopen(fd, "wb") as f:
            np.save(f, array)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
