"""MIL training losses (counterpart of the JAX package's ``losses/``)."""

from .base import contrastive_loss, pairwise_distance, smoothness_loss, sparsity_loss
from .mgfn import bce_loss, mgfn_loss

__all__ = [
    "bce_loss",
    "contrastive_loss",
    "mgfn_loss",
    "pairwise_distance",
    "smoothness_loss",
    "sparsity_loss",
]
