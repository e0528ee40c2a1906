"""Tracing and per-stage timers (counterpart of the JAX package's
``utils/profiling.py``).

- ``trace(logdir)``: a ``torch.profiler`` recording of the block, CPU
  activity and, where torch sees a card, CUDA activity (kernels, copies),
  written on exit as a Chrome trace under ``logdir``, which TensorBoard's
  profiler plugin, Perfetto and ``chrome://tracing`` open; the JAX module's
  ``trace`` wraps ``jax.profiler`` the same way.
- ``device_kernel_ms``: a recording's device time by kernel name.
- ``StageTimer``: cheap accumulating wall-clock timers for the stages of
  extraction (decode wait, device extract), read by the extraction CLI's
  ``--profile``.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from collections import defaultdict
from typing import Any, Dict, Iterator


# idle time at each end of the recorded window on the card: the profiler
# keeps the device records that fall inside the window by their timestamps,
# and a kernel's start, mapped to the host clock, can read milliseconds
# before its own launch (chip_smoke.py --trace-probe measures it)
WINDOW_PAD_S = 0.05
# tiny kernels run at the head of the recorded window on the card, there to
# be lost in place of the block's: a profiler session of torch 2.11 on an
# H100 can lose the first N kernel records it sees, N growing by about one
# per 15 s of the process's age and now and then falling back to 0
SACRIFICE_KERNELS = 1024
SACRIFICE_KERNEL_NAME = "spin_kernel"  # ``torch.cuda._sleep``'s


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[Any]:
    """Profile the block; on exit write ``<host>_<pid>.<stamp>.pt.trace.json``
    under ``logdir``. Yields the ``torch.profiler.profile`` (its events and
    ``key_averages()`` are read after the block).

    On the card the recording opens with ``SACRIFICE_KERNELS`` one-cycle
    ``torch.cuda._sleep`` kernels, waited for, under the range
    ``trace: warm-up``: the profiler drops the first kernel records of a
    session, more of them the older the process, and these absorb the loss
    so that the block's own records survive. The block then starts
    ``WINDOW_PAD_S`` after them and the window closes as long after it,
    the device idle and waited for, because the profiler also drops device
    records whose host-clock start falls outside the window. A trace in
    which not one warm-up kernel survived may lack the block's first
    records too, and says so in a warning."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            with record_function("trace: warm-up"):
                for _ in range(SACRIFICE_KERNELS):
                    torch.cuda._sleep(1)
                torch.cuda.synchronize()
            time.sleep(WINDOW_PAD_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()
            time.sleep(WINDOW_PAD_S)
    if cuda and warmup_kernels_kept(prof) == 0:
        warnings.warn(f"trace: the profiler dropped all {SACRIFICE_KERNELS} warm-up kernel "
                      "records, so the block's first device records may be missing too")
    tensorboard_trace_handler(logdir)(prof)


def warmup_kernels_kept(prof) -> int:
    """How many of ``trace``'s warm-up kernels the profiler recorded."""
    return sum(SACRIFICE_KERNEL_NAME in e.name() for e in prof.profiler.kineto_results.events())


def device_kernel_ms(prof) -> Dict[str, float]:
    """Device time in ms by kernel (or copy) name in a finished recording,
    ``trace``'s warm-up kernels left out; empty where the recording holds
    no device activity (on the CPU)."""
    from torch.autograd import DeviceType

    totals: Dict[str, float] = defaultdict(float)
    for evt in prof.events():
        # device-side records only, not the ranges a record_function spans over them
        if (evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False)
                or SACRIFICE_KERNEL_NAME in evt.key):
            continue
        totals[evt.key] += evt.time_range.elapsed_us() / 1e3
    return dict(totals)


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
