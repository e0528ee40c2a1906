"""RTFM hyperparameters (counterpart of the JAX package's
``models/rtfm/config.py``; the paper's and official release's defaults):
2048-d I3D features, a 512/128 scoring MLP with dropout 0.7, top-k 3 by
feature magnitude, magnitude margin 100."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RTFMConfig:
    channels: int = 2048
    hidden_dims: Tuple[int, int] = (512, 128)
    dropout_rate: float = 0.7
    k: int = 3
    margin: float = 100.0
    alpha: float = 0.0001
    smoothness_lambda: float = 8e-4
    sparsity_lambda: float = 8e-3
