"""The order in which the project's Tier-1 command (``pytest tests/ -m 'not
slow' -n 6 --dist loadfile``) hands test files to its six workers.

pytest-xdist's ``loadfile`` scheduler queues one unit of work per file.
``LoadFileScheduling`` inherits ``schedule`` and ``_reschedule`` from
``xdist/scheduler/loadscope.py``:

- ``schedule``, with ``--loadscope-reorder`` (on by default): "Insert tests
  scopes into work queue ordered by number of tests", a stable sort on the
  negated count, so ties keep collection order; then each worker is given
  one unit;
- ``_reschedule``: a worker is given the next unit only when 2 or fewer of
  its tests are still pending ("Heuristic of minimum tests to enqueue more
  work").

So the first six files of that order start at once and every later file
waits for a worker to free up. ``tests/test_extraction.py`` and
``tests/test_training.py``, the JAX package's, take the longest, and the
run cannot end before they do: they must be the first two files of the
queue. A port file (``tests/test_torch_*.py``) therefore collects at most
27 Tier-1 tests, fewer than either of them.
"""

import collections

import pytest

LONG_POLES = ("tests/test_extraction.py", "tests/test_training.py")


def loadfile_order(nodeids):
    """[(file, test count)] in the order of xdist's loadfile queue: count
    descending, ties in collection order."""
    counts = collections.Counter(nodeid.split("::", 1)[0] for nodeid in nodeids)
    return sorted(counts.items(), key=lambda item: -item[1])


def test_jax_long_poles_lead_the_loadfile_queue(request):
    """With ``-m 'not slow'`` already applied to the session's items (each
    xdist worker collects the whole session), the two JAX long poles are
    the first two files of the queue."""
    order = loadfile_order([item.nodeid for item in request.session.items])
    files = [name for name, _ in order]
    missing = [name for name in LONG_POLES if name not in files]
    if missing:
        pytest.skip(f"the session does not hold {' and '.join(missing)}: the queue's order "
                    "is that of a run of the whole of tests/")
    last = max(files.index(name) for name in LONG_POLES)
    ahead = [(name, count) for name, count in order[:last] if name not in LONG_POLES]
    counts = dict(order)
    assert not ahead, (
        "ahead of the JAX long poles in the -n 6 --dist loadfile queue ("
        + ", ".join(f"{name} {counts[name]}" for name in LONG_POLES) + " tests): "
        + ", ".join(f"{name} with {count} tests" for name, count in ahead)
        + "; split each into files of at most 27 Tier-1 tests")
