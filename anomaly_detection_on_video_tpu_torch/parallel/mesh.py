"""Process meshes over ``torch.distributed`` (counterpart of the JAX
package's ``parallel/mesh.py``).

One process drives one card, so a mesh is a grid of ranks, not of devices:
``make_mesh((4,), ("data",))`` shards the MIL bag axis over four ranks,
``make_mesh((2, 2), ("data", "model"))`` is DP x TP, row-major as the JAX
``make_mesh`` lays devices out (rank = data index * model size + model
index). ``initialize_multihost`` joins the ranks: over TCP with an explicit
``coordinator`` (``host:port``), or from torchrun's ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (``env://``) when asked to
autodetect. The process group's backend follows the device: ``nccl`` for
CUDA, ``gloo`` for the CPU. ``barrier`` synchronizes through the rendezvous
store, not through a collective, so it tolerates hours of skew.
"""

from __future__ import annotations

import atexit
import datetime
import math
import os
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the rendezvous of this process: store, rank, world size, whether this module
# made the process group, and how often each barrier name was used
_STATE: Dict[str, object] = {}
DEFAULT_TIMEOUT_S = 1800  # the process group's: a rank that dies fails its peers' collectives


class Mesh:
    """A grid of ranks with named axes: ``shape`` maps each axis name to
    its size, in the grid's order; ``coordinate(axis)`` is this rank's
    index along an axis and ``group(axis)`` the process group of the ranks
    that differ from it only along that axis. A mesh built without groups
    (``Mesh({"data": 4, "model": 2})``) describes a layout only, as
    ``tensor_parallel_specs`` needs."""

    def __init__(self, shape: Dict[str, int], rank: int = 0, groups: Optional[Dict] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.rank = rank
        self._groups = dict(groups or {})

    def coordinate(self, axis: str) -> int:
        stride = math.prod(list(self.shape.values())[self.axis_names.index(axis) + 1:])
        return (self.rank // stride) % self.shape[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _axis_groups(shape: Tuple[int, ...]) -> Dict[int, list]:
    """For each axis, every list of ranks that differ only along it, in a
    fixed order (``new_group`` must see the same calls on every rank)."""
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    out = {}
    for axis in range(len(shape)):
        moved = ranks.movedim(axis, -1).reshape(-1, shape[axis])
        out[axis] = [row.tolist() for row in moved]
    return out


def make_mesh(axis_shapes: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """A mesh over every rank of the process group (one rank without
    one). Default: all ranks on one ``data`` axis."""
    world = process_count()
    if axis_shapes is None:
        axis_shapes = (world,)
    axis_shapes = tuple(int(s) for s in axis_shapes)
    if math.prod(axis_shapes) != world:
        raise ValueError(f"mesh shape {axis_shapes} does not cover {world} devices")
    if len(axis_shapes) != len(axis_names):
        raise ValueError("axis_shapes and axis_names must align")
    rank = process_index()
    groups = {}
    if dist.is_initialized():
        for axis, rows in _axis_groups(axis_shapes).items():
            for row in rows:
                group = dist.group.WORLD if len(row) == world else dist.new_group(row)
                if rank in row:
                    groups[axis_names[axis]] = group
    return Mesh(dict(zip(axis_names, axis_shapes)), rank, groups)


def local_mesh() -> Mesh:
    """1-D ``data`` mesh over every rank."""
    return make_mesh((process_count(),), ("data",))


def initialize_multihost(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, autodetect: bool = False,
                         device="cuda", process_group: bool = True,
                         timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[torch.device]:
    """Join the other processes of a multi-host run; returns this rank's
    device (None when there is nothing to join).

    ``coordinator`` (``host:port``, with ``num_processes`` and
    ``process_id``) rendezvous over TCP, process 0 hosting the store;
    ``autodetect`` without a coordinator reads torchrun's environment
    (``env://``); with neither this does nothing, as in the JAX package. A
    CUDA rank takes the card ``LOCAL_RANK``, else ``process_id`` modulo the
    visible cards. ``process_group=False`` joins the store only (what
    ``barrier`` needs), so several processes may share one card; otherwise
    the process group starts with ``nccl`` on CUDA, ``gloo`` on the CPU,
    and a collective that a dead rank never joins fails after
    ``timeout_s``."""
    if coordinator is None and not autodetect:
        return None
    if _STATE:
        raise RuntimeError("initialize_multihost was already called in this process")
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
                   if k not in os.environ]
        if missing:
            raise SystemExit(f"multihost autodetect needs torchrun's environment ({', '.join(missing)}"
                             " unset); pass a coordinator, num_processes and process_id instead")
        store, rank, world = next(dist.rendezvous("env://", timeout=timeout))
    else:
        if num_processes is None or process_id is None:
            raise SystemExit("a coordinator needs num_processes and process_id")
        store, rank, world = next(dist.rendezvous(
            f"tcp://{coordinator}", rank=int(process_id), world_size=int(num_processes),
            timeout=timeout))
    device = torch.device(device)
    if device.type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    _STATE.update(store=store, rank=rank, world=world, group=False, barriers={})
    if process_group:
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo", store=store,
                                rank=rank, world_size=world, timeout=timeout)
        _STATE["group"] = True
    atexit.register(shutdown, clean=False)
    return device


def process_index() -> int:
    if _STATE:
        return int(_STATE["rank"])
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    if _STATE:
        return int(_STATE["world"])
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(name: str, timeout_s: float = 86400) -> None:
    """Wait until every process has reached the barrier ``name``.

    Through the rendezvous store's counters, not a collective: NCCL's
    watchdog and gloo's collective timeouts would kill a sweep whose shards
    finish hours apart; this waits ``timeout_s`` (a day by default), the
    JAX package's coordination-service barrier. Process 0, which hosts the
    store, leaves last, so no peer loses the store inside the barrier.
    Each name may be used any number of times. No-op with one process."""
    if not _STATE or int(_STATE["world"]) == 1:
        return
    store, world = _STATE["store"], int(_STATE["world"])
    uses = _STATE["barriers"]
    uses[name] = uses.get(name, 0) + 1
    key = f"barrier/{name}/{uses[name]}"
    timeout = datetime.timedelta(seconds=timeout_s)
    if store.add(f"{key}/in", 1) == world:
        store.set(f"{key}/all_in", "1")
    store.wait([f"{key}/all_in"], timeout)
    if store.add(f"{key}/out", 1) == world:
        store.set(f"{key}/all_out", "1")
    if int(_STATE["rank"]) == 0:
        store.wait([f"{key}/all_out"], timeout)


def shutdown(clean: bool = True) -> None:
    """Leave the run: with ``clean``, a last barrier (a minute at most)
    so process 0 keeps the store until its peers are done; then the
    process group, if ``initialize_multihost`` made it, is destroyed.
    Called at exit (not clean) when the program did not call it."""
    if not _STATE:
        return
    try:
        if clean:
            barrier("shutdown", timeout_s=60)
    finally:
        if _STATE.get("group") and dist.is_initialized():
            dist.destroy_process_group()
        _STATE.clear()
