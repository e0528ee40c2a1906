"""Padded-bucket scoring (counterpart of the JAX package's
``training/runner.py`` ``make_eval_step`` and ``eval_bucket``)."""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..utils.device import full_f32


def eval_bucket(n_clips: int, minimum: int = 32) -> int:
    """Pad the clip axis to a power-of-two bucket (at least ``minimum``)."""
    bucket = minimum
    while bucket < n_clips:
        bucket *= 2
    return bucket


def make_eval_step() -> Callable[[nn.Module, torch.Tensor, torch.Tensor], torch.Tensor]:
    """The scoring step: ``step(model, feature (bs, ncrops, bucket, C+1),
    length (bs,)) -> scores (bs, bucket, 1)``.

    It runs in full float32 with TF32 off for cuDNN and cuBLAS, as the JAX
    step pins "highest" matmul precision: the scorer's operations are
    negligible next to extraction, and lower-precision products are not a
    stable numeric contract.
    """

    @torch.no_grad()
    def step(model: nn.Module, feature: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
        with full_f32():
            return model(feature, length=length)

    return step
