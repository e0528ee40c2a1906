"""Interleaved A/B on the card: serial per-chunk extraction against the
one-deep dispatch pipeline, same video, same process (the port's
counterpart of ``scripts/overlap_ab.py``).

A seeded 1536-frame 240 x 320 MJPG (a random walk of pixel values) is
written with OpenCV, then extracted in bf16 four times each way, in turns:

- serial: ``extract_frames`` on each 256-frame chunk of a
  ``VideoFrameSource``, each call waiting for its features before the
  next chunk is taken;
- pipelined: ``FeatureExtractor.extract_video``, which dispatches chunk N
  to the extractor's worker thread before waiting for chunk N-1, so decode
  overlaps device work.

The two must give bit-equal features (it raises otherwise); the record
holds each run's seconds on the host clock and the medians' clips/s.

    python -m anomaly_detection_on_video_tpu_torch.scripts.overlap_ab [--device cpu]
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..data.extraction import FeatureExtractor
from ..data.video import VideoFrameSource
from ..utils.measure import guarded, probe_cli

N_FRAMES = 6 * 256
CHUNK_FRAMES = 256
REPS = 4


def write_video(path: str, n_frames: int = N_FRAMES, size: Sequence[int] = (240, 320),
                rng: Optional[np.random.RandomState] = None) -> None:
    """A seeded MJPG of ``n_frames`` (H, W) frames: each frame the last plus
    uniform steps in [-12, 12], clipped to uint8."""
    import cv2

    rng = rng or np.random.RandomState(1)
    h, w = size
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30.0, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"OpenCV cannot write {path}")
    base = rng.randint(0, 256, (h, w, 3), np.uint8)
    try:
        for _ in range(n_frames):
            base = np.clip(base.astype(np.int16) + rng.randint(-12, 13, base.shape, np.int16),
                           0, 255).astype(np.uint8)
            writer.write(base)
    finally:
        writer.release()


def overlap_ab(extractor: FeatureExtractor, path: str, n_frames: int,
               chunk_frames: int = CHUNK_FRAMES, reps: int = REPS) -> dict:
    """``reps`` runs of each mode in turns over the video at ``path``; raises
    unless every run's features equal the first's bit for bit."""
    def run_serial() -> np.ndarray:
        source = VideoFrameSource(path, chunk_frames)
        try:
            return np.vstack([extractor.extract_frames(chunk) for chunk in source])
        finally:
            source.close()

    def run_pipelined() -> np.ndarray:
        return extractor.extract_video(path, chunk_frames=chunk_frames)

    times = {"serial": [], "pipelined": []}
    ref = None
    for _ in range(reps):
        for name, fn in (("serial", run_serial), ("pipelined", run_pipelined)):
            start = time.perf_counter()
            out = fn()
            times[name].append(time.perf_counter() - start)
            if ref is None:
                ref = out
            else:
                np.testing.assert_array_equal(ref, out)  # bit-equal modes
    n_clips = n_frames // 16
    med = {k: float(np.median(v)) for k, v in times.items()}
    return {
        "probe": "overlap_ab",
        "serial_s": [round(t, 3) for t in times["serial"]],
        "pipelined_s": [round(t, 3) for t in times["pipelined"]],
        "median_serial_clips_per_sec": round(n_clips / med["serial"], 2),
        "median_pipelined_clips_per_sec": round(n_clips / med["pipelined"], 2),
        "median_speedup": round(med["serial"] / med["pipelined"], 3),
        "modes_bit_equal": True,
    }


def probe_overlap(device: torch.device, reps: int = REPS) -> dict:
    """The JAX probe's run: its video, a bf16 extractor warmed on one chunk
    of seeded frames."""
    rng = np.random.RandomState(1)
    with tempfile.TemporaryDirectory(prefix="overlap_ab_") as tmp:
        path = os.path.join(tmp, "v.avi")
        write_video(path, N_FRAMES, rng=rng)
        ex = FeatureExtractor(dtype=torch.bfloat16, device=device)
        ex.extract_frames(rng.randint(0, 256, (CHUNK_FRAMES, 240, 320, 3), np.uint8))
        return overlap_ab(ex, path, N_FRAMES, CHUNK_FRAMES, reps)


def run(device: torch.device, reps: Optional[int] = None) -> Iterator[dict]:
    """The record, guarded; ``reps`` replaces the JAX probe's 4."""
    yield from guarded("overlap_ab", lambda: probe_overlap(device, reps or REPS))


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return probe_cli(__doc__, run, argv)


if __name__ == "__main__":
    main()
