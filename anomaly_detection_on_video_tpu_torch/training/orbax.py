"""Read and write one step of the JAX package's orbax checkpoints (its
``training/checkpoints.py`` ``TopKCheckpointer``), with no jax, orbax or
tensorstore.

A step directory ``<dir>/<step>/`` holds:

- ``default/_METADATA``: JSON whose ``tree_metadata`` lists every leaf of
  the saved ``{"params", "batch_stats", "opt_state", "step"}`` tree by its
  key path (``key_type`` 2 a dict key, 1 a sequence index) and marks the
  leaves that hold no array (``skip_deserialize``: optax's empty
  ``EmptyState``, an empty ``batch_stats`` dict);
- ``default/``: an OCDBT store (``utils/ocdbt.py``) holding one zarr v2
  array per leaf (``utils/zarr.py``), named by the key path joined with
  ``.`` (``params.fc.kernel``);
- ``metrics/metrics``: the save's metric as JSON (``{"metric": 0.7}``),
  absent for a metric-less save;
- ``_CHECKPOINT_METADATA``: orbax's JSON about the save.

``read_orbax_step`` rebuilds the tree as nested dicts and lists of numpy
arrays (``torch.bfloat16`` tensors for bfloat16 leaves); ``utils/convert.
train_state_from_orbax`` loads it into the port's ``TrainState``.

``write_orbax_step`` is its inverse, what orbax's ``StandardSave`` writes
in a one-process save (``utils/convert.train_state_to_orbax`` makes the
tree): ``_METADATA``, ``_sharding`` (every array on one host device) and
``array_metadatas/process_0`` beside one OCDBT database at ``default/``
(``OcdbtWriter``; orbax's own save adds a per-process database under it
that the root one refers into, which a reader does not tell apart), then
``metrics/metrics`` and ``_CHECKPOINT_METADATA``. Restoring a port-written
step with the JAX ``TopKCheckpointer.restore`` gives the same arrays.
"""

from __future__ import annotations

import base64
import json
import os
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

from ..utils.ocdbt import OcdbtStore, OcdbtWriter
from ..utils.zarr import encode_array, read_array

ITEM_DIR = "default"
TREE_METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
METRICS_PATH = os.path.join("metrics", "metrics")
_EMPTY = {"None": None, "Dict": dict, "List": list, "Tuple": list}
HANDLERS = "orbax.checkpoint._src.handlers."
ITEM_HANDLERS = {ITEM_DIR: HANDLERS + "standard_checkpoint_handler.StandardCheckpointHandler",
                 "metrics": HANDLERS + "json_checkpoint_handler.JsonCheckpointHandler"}
# the sharding recorded for every array: one device of the host, as a
# save from host memory records it (the JAX restore takes its template's)
SHARDING = json.dumps({"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})


def is_orbax_step(path: str) -> bool:
    """Whether ``path`` is a step directory in orbax's format, written by
    orbax or by the port (an earlier port's steps hold ``state.pt``)."""
    return (os.path.isfile(os.path.join(path, CHECKPOINT_METADATA))
            or os.path.isfile(os.path.join(path, ITEM_DIR, TREE_METADATA)))


def _read_json(path: str) -> Optional[Any]:
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def read_orbax_metrics(step_dir: str) -> Optional[Dict[str, Any]]:
    """The metrics saved with the step (None for a metric-less save)."""
    return _read_json(os.path.join(step_dir, METRICS_PATH))


def read_checkpoint_metadata(step_dir: str) -> Optional[Dict[str, Any]]:
    """orbax's ``_CHECKPOINT_METADATA`` of the step (None where absent)."""
    return _read_json(os.path.join(step_dir, CHECKPOINT_METADATA))


def _insert(tree: dict, path: list, value: Any) -> None:
    """Place ``value`` at ``path`` ((key, key_type) pairs), making dicts
    for dict keys and lists (indexed by position) for sequence keys."""
    node = tree
    for (key, key_type), (next_key, next_type) in zip(path, path[1:] + [(None, None)]):
        index = int(key) if key_type == 1 else key
        if key_type == 1:
            node.extend([None] * (index + 1 - len(node)))
        if next_key is None:
            node[index] = value
            return
        if node[index] is None if key_type == 1 else index not in node:
            node[index] = [] if next_type == 1 else {}
        node = node[index]


def read_orbax_step(step_dir: str) -> Dict[str, Any]:
    """The tree saved in one orbax step: ``{"params", "batch_stats",
    "opt_state", "step"}`` as nested dicts (dict keys) and lists
    (sequence indices: optax's chain and its states) of numpy arrays. A
    leaf that holds no array comes back empty (None for an ``EmptyState``,
    ``{}`` for an empty dict). A legacy 2-slot ``opt_state`` (the
    add_decayed_weights + adam chain from before the gradient-clip slot)
    gets the empty slot 0 prepended, as the JAX checkpointer's restore
    migrates it, with a warning."""
    meta_path = os.path.join(step_dir, ITEM_DIR, TREE_METADATA)
    meta = _read_json(meta_path)
    if meta is None:
        raise ValueError(f"{step_dir}: not a readable orbax step (no {ITEM_DIR}/{TREE_METADATA})")
    if meta.get("use_zarr3"):
        raise ValueError(f"{step_dir}: a zarr v3 orbax step; only zarr v2 steps are read")
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{step_dir}: an orbax step without OCDBT; only OCDBT steps are read")
    store = OcdbtStore(os.path.join(step_dir, ITEM_DIR))
    keys = {k.decode() for k in store.list()}
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        path = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        value_meta = entry["value_metadata"]
        if value_meta.get("skip_deserialize"):
            empty = _EMPTY.get(value_meta.get("value_type"))
            value = empty() if callable(empty) else None
        else:
            name = ".".join(str(k) for k, _ in path)
            value = read_array(store.read, keys, name)
        _insert(tree, path, value)
    opt_state = tree.get("opt_state")
    if isinstance(opt_state, list) and len(opt_state) == 2:
        warnings.warn(f"checkpoint step {os.path.basename(os.path.normpath(step_dir))} carries "
                      "a legacy 2-slot optimizer state (pre-gradient-clip layout); migrated by "
                      "prepending the fresh identity slot")
        tree["opt_state"] = [None] + opt_state
    return tree


def _leaves(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """((key, key_type), ...) paths and leaves of ``tree`` in the order
    jax flattens it: dict keys sorted (key_type 2), list and tuple items
    in order (key_type 1); None and an empty dict are leaves."""
    if isinstance(tree, dict) and tree:
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key], path + ((key, 2),))]
    if isinstance(tree, (list, tuple)) and tree:
        return [leaf for i, item in enumerate(tree) for leaf in _leaves(item, path + ((str(i), 1),))]
    return [(path, tree)]


def _write_json(path: str, value: Any, **kw) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps(value, **kw))  # one write: json.dump writes piece by piece


def write_orbax_step(step_dir: str, tree: Dict[str, Any], metric: Optional[float] = None) -> None:
    """Write ``tree`` (``{"params", "batch_stats", "opt_state", "step"}``
    as nested dicts and lists of numpy arrays or tensors; None for an
    ``EmptyState``) into the new directory ``step_dir`` as orbax writes
    one step, with ``metrics/metrics`` when ``metric`` is given. The
    caller makes the step visible (a rename into place)."""
    init_ns = time.time_ns()
    item = os.path.join(step_dir, ITEM_DIR)
    os.makedirs(item)
    tree_metadata, shardings, array_metadatas = {}, {}, []
    arrays = []
    for path, leaf in _leaves(tree):
        entry = {"key_metadata": [{"key": k, "key_type": t} for k, t in path]}
        if leaf is None or isinstance(leaf, (dict, list, tuple)):  # empty: _leaves
            value_type = "None" if leaf is None else "Dict" if isinstance(leaf, dict) else "List"
            entry["value_metadata"] = {"value_type": value_type, "skip_deserialize": True}
        else:
            name = ".".join(k for k, _ in path)
            shape = list(leaf.shape)
            arrays.append((name, leaf))
            entry["value_metadata"] = {"value_type": "jax.Array", "skip_deserialize": False,
                                       "write_shape": shape}
            shardings[base64.b64encode(name.encode()).decode()] = SHARDING
            array_metadatas.append({"array_metadata": {
                "param_name": name, "write_shape": shape, "chunk_shape": shape,
                "ext_metadata": None}})
        tree_metadata[str(tuple(k for k, _ in path))] = entry
    # the copies into C order and zstd release the GIL: encode on threads,
    # store in order on this one
    with OcdbtWriter(item) as writer, ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for items in pool.map(lambda named: encode_array(*named), arrays):
            for key, value in items:
                writer.put(key, value)
    _write_json(os.path.join(item, TREE_METADATA), {
        "tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    _write_json(os.path.join(item, "_sharding"), shardings, separators=(",", ":"))
    _write_json(os.path.join(item, "array_metadatas", "process_0"),
                {"array_metadatas": array_metadatas})
    handlers = {ITEM_DIR: ITEM_HANDLERS[ITEM_DIR]}
    if metric is not None:
        _write_json(os.path.join(step_dir, METRICS_PATH), {"metric": float(metric)})
        handlers["metrics"] = ITEM_HANDLERS["metrics"]
    _write_json(os.path.join(step_dir, CHECKPOINT_METADATA), {
        "item_handlers": handlers, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": init_ns, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}})
