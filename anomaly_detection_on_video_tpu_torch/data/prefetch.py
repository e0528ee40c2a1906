"""Background-thread prefetch (counterpart of the JAX package's
``data/prefetch.py``).

One daemon thread keeps up to ``depth`` items of an iterator assembled
ahead of the consumer, so host work on item N+1 overlaps the device's work
on item N. Order is preserved (one worker, a FIFO queue), so a prefetched
loop and a serial one give the same items.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_DONE = object()


class _WorkerError:
    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


def prefetch(iterable: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Yield ``iterable``'s items in order while a daemon thread keeps up
    to ``depth`` of them ready.

    An exception in the worker re-raises at the consumer's next pull.
    Abandoning the iterator (``break``, ``close()``) stops the worker: its
    puts time out against a stop event, so it never stays blocked.
    """
    depth = int(depth)
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for item in iterable:
                if not _put(item):
                    return
        except BaseException as exc:  # re-raised on the consumer side
            _put(_WorkerError(exc))
            return
        _put(_DONE)

    thread = threading.Thread(target=worker, name="batch-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, _WorkerError):
                raise item.exc
            yield item
    finally:
        stop.set()
        # free one slot so a worker blocked in put() sees the stop
        try:
            q.get_nowait()
        except queue.Empty:
            pass
        thread.join(timeout=5.0)
