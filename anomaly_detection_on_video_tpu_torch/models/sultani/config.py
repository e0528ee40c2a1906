"""Sultani MIL hyperparameters (counterpart of the JAX package's
``models/sultani/config.py``; the official release's defaults): FC
512 -> 32 -> 1 with dropout 0.6 and ranking-loss lambdas 8e-5, on 2048-d
I3D features (the paper's C3D features are 4096-d)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SultaniConfig:
    channels: int = 2048
    hidden_dims: Tuple[int, int] = (512, 32)
    dropout_rate: float = 0.6
    smoothness_lambda: float = 8e-5
    sparsity_lambda: float = 8e-5
