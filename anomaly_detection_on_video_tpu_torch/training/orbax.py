"""Read one step of the JAX package's orbax checkpoints (its
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
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Optional

from ..utils.ocdbt import OcdbtStore
from ..utils.zarr import read_array

ITEM_DIR = "default"
TREE_METADATA = "_METADATA"
CHECKPOINT_METADATA = "_CHECKPOINT_METADATA"
METRICS_PATH = os.path.join("metrics", "metrics")
_EMPTY = {"None": None, "Dict": dict, "List": list, "Tuple": list}


def is_orbax_step(path: str) -> bool:
    """Whether ``path`` is a step directory orbax wrote (the port's own
    steps hold ``state.pt`` instead)."""
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
