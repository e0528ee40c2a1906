"""Tracing and per-stage timers (counterpart of the JAX package's
``utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` recording of the block, CPU
  activity and, where torch sees a card, CUDA activity (kernels, copies),
  written on exit as a Chrome trace under ``logdir``, which TensorBoard's
  profiler plugin, Perfetto and ``chrome://tracing`` open; the JAX module's
  ``trace`` wraps ``jax.profiler`` the same way.
- ``StageTimer``: cheap accumulating wall-clock timers for the stages of
  extraction (decode wait, device extract), read by the extraction CLI's
  ``--profile``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Any, Dict, Iterator


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[Any]:
    """Profile the block; on exit write ``<host>_<pid>.<stamp>.pt.trace.json``
    under ``logdir``. Yields the ``torch.profiler.profile`` (its events and
    ``key_averages()`` are read after the block)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


class StageTimer:
    """Wall-clock seconds and call counts per named stage."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "count": self.counts[name],
                "mean_ms": round(1000 * self.totals[name] / max(self.counts[name], 1), 2),
            }
            for name in self.totals
        }

    def report(self) -> str:
        """One line: ``<stage>: <total>s/<count>x (<mean>ms) | ...``."""
        return " | ".join(
            f"{name}: {s['total_s']:.2f}s/{s['count']}x ({s['mean_ms']:.1f}ms)"
            for name, s in self.summary().items()
        )
