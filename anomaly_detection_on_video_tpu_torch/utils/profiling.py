"""Per-stage pipeline timers (counterpart of the JAX package's
``utils/profiling.py`` ``StageTimer``): cheap accumulating wall-clock
timers for the stages of extraction (decode wait, device extract), read by
the extraction CLI's ``--profile``. The JAX module's ``trace`` wraps the
JAX profiler and has no counterpart here."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


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
