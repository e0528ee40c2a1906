"""MGFN hyperparameters (counterpart of the JAX package's
``models/mgfn/config.py``; reference defaults): dims (64, 128, 1024), depths
(3, 3, 2), block types glance/focus/focus, 2048-d features + 1 magnitude
channel, top-k 3, magnitude ratio 0.1."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MGFNConfig:
    classes: int = 0
    dims: Tuple[int, ...] = (64, 128, 1024)
    depths: Tuple[int, ...] = (3, 3, 2)
    mgfn_types: Tuple[str, ...] = ("gb", "fb", "fb")
    lokernel: int = 5
    channels: int = 2048
    ff_repe: int = 4
    dim_head: int = 64
    local_aggr_kernel: int = 5
    dropout: float = 0.0
    attention_dropout: float = 0.0
    dropout_rate: float = 0.7
    mag_ratio: float = 0.1
    k: int = 3

    def __post_init__(self):
        if len(self.dims) != len(self.depths) or len(self.dims) != len(self.mgfn_types):
            raise ValueError("dims, depths and mgfn_types must have equal length")
        for t in self.mgfn_types:
            if t not in ("gb", "fb"):
                raise ValueError("mgfn block type must be either 'gb' or 'fb'")
