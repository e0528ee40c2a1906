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


# idle time at each end of the recorded window on the card: the profiler
# keeps the device records that fall inside the window by their timestamps,
# and a kernel's start, mapped to the host clock, can read milliseconds
# before its own launch (chip_smoke.py --trace-probe measures it)
WINDOW_PAD_S = 0.05


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[Any]:
    """Profile the block; on exit write ``<host>_<pid>.<stamp>.pt.trace.json``
    under ``logdir``. Yields the ``torch.profiler.profile`` (its events and
    ``key_averages()`` are read after the block).

    The profiler starts in a warm-up step whose records are discarded: on
    the card one device op runs and is waited for there, so CUDA activity
    tracing is live before the block's first kernel. The recorded window
    then opens ``WINDOW_PAD_S`` before the block and closes as long after
    it, the device idle and waited for: the profiler drops device records
    whose host-clock start falls outside the window, and that mapping
    jitters, so a block's first kernels were lost without the margin."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        if cuda:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        prof.step()  # warm-up -> recording
        if cuda:
            time.sleep(WINDOW_PAD_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()
            time.sleep(WINDOW_PAD_S)


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
