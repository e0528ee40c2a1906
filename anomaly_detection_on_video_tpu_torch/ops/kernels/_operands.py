"""Kernel operands packed once per module and reused across launches.

A wrapper's kernel takes its weights folded and permuted (``pack_*``).
Packing on every call would add a dozen small device ops and host work to
each launch, so the packed operands are kept on the module they come from,
one set per (dtype, device), and packed again only when one of their source
tensors has changed: written in place (``load_state_dict`` copies, an
optimizer step, BN running stats in training mode) or replaced (``.to``),
or the settings they were packed for have changed (an int8 conv's input
scale).
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Sequence

import torch
from torch import nn


def cached_operands(
    owner: nn.Module,
    sources: Sequence[torch.Tensor],
    key: Hashable,
    pack: Callable[[], Dict[str, torch.Tensor]],
    settings: Hashable = None,
) -> Dict[str, torch.Tensor]:
    """``pack()``'s result for ``key``, computed once and kept on ``owner``
    until a tensor of ``sources`` or ``settings`` changes; a new result
    replaces the old one."""
    stamp = (tuple((t.data_ptr(), t._version) for t in sources), settings)
    cache = owner.__dict__.setdefault("_kernel_operands", {})
    entry = cache.get(key)
    if entry is None or entry[0] != stamp:
        entry = cache[key] = (stamp, pack())
    return entry[1]
