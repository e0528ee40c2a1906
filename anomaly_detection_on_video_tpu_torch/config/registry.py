"""``_target_``-style object instantiation (the port's counterpart of the
JAX package's ``config/registry.py``).

The repository's ``configs/`` name the JAX package's classes
(``_target_``, ``cls``, ``model_class``). ``locate`` reads a dotted name
under the JAX package as the same name under this package, whose layout
mirrors it (``models.MGFNConfig``, ``models.MGFNForVideoAnomalyDetection``,
``training.VideoAnomalyDetectionRunner``), and imports only that: the JAX
package is never imported. A name the port does not have raises
ImportError.
"""

from __future__ import annotations

import importlib
from typing import Any

PORT_PACKAGE = __name__.split(".")[0]
REFERENCE_PACKAGE = PORT_PACKAGE.removesuffix("_torch")


def port_path(path: str) -> str:
    """A dotted name under the JAX package -> the same name in the port;
    any other name unchanged."""
    head, dot, rest = path.partition(".")
    return f"{PORT_PACKAGE}{dot}{rest}" if head == REFERENCE_PACKAGE else path


def locate(path: str) -> Any:
    """Resolve a dotted path like ``package.module.ClassName`` to the
    object, names under the JAX package read as the port's."""
    target = port_path(path)
    parts = target.split(".")
    for split in range(len(parts), 0, -1):
        module_name = ".".join(parts[:split])
        try:
            obj = importlib.import_module(module_name)
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError as exc:
            raise ImportError(f"could not locate {path!r}: the port has no {target!r}") from exc
        return obj
    raise ImportError(f"could not locate {path!r}")


def instantiate(node: Any, **kwargs: Any) -> Any:
    """Recursively instantiate ``_target_`` nodes: a dict with a
    ``_target_`` becomes ``locate(_target_)(**rest)``, nested dicts and
    lists first; other nodes pass through."""
    if isinstance(node, dict):
        resolved = {key: instantiate(val) for key, val in node.items() if key != "_target_"}
        resolved.update(kwargs)
        if "_target_" in node:
            return locate(node["_target_"])(**resolved)
        return resolved
    if isinstance(node, (list, tuple)):
        return type(node)(instantiate(item) for item in node)
    return node
