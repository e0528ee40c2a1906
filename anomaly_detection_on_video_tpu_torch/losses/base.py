"""MIL ranking-loss primitives (counterpart of the JAX package's
``losses/base.py``), with the reference's constants: temporal smoothness
λ1 = 8e-4, sparsity λ2 = 8e-3, contrastive margin 200. Kept as the
reference has them: sparsity takes ``mean(norm(x, dim=0))`` of an already
flat vector, its L2 norm; the pairwise distance adds its eps = 1e-6 inside
the difference, as ``torch.pairwise_distance`` does.
"""

from __future__ import annotations

import torch


def smoothness_loss(scores: torch.Tensor, lambda1: float = 8e-4) -> torch.Tensor:
    """λ1 * Σ (s_{t+1} - s_t)^2 over the clip axis (axis 1)."""
    diff = scores[:, 1:, :] - scores[:, :-1, :]
    return lambda1 * torch.sum(diff ** 2)


def sparsity_loss(scores: torch.Tensor, lambda2: float = 8e-3) -> torch.Tensor:
    """λ2 * mean(L2 norm over axis 0). On a flat vector: λ2 * ||x||_2."""
    return lambda2 * torch.mean(torch.linalg.vector_norm(scores, dim=0))


def pairwise_distance(x1: torch.Tensor, x2: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """||x1 - x2 + eps||_2 over the last axis, kept as (..., 1)."""
    return torch.linalg.vector_norm(x1 - x2 + eps, dim=-1, keepdim=True)


def contrastive_loss(output1: torch.Tensor, output2: torch.Tensor, label: float,
                     margin: float = 200.0) -> torch.Tensor:
    """Margin hinge on the pairwise distance: label 0 pulls the pair
    together, label 1 pushes it apart up to ``margin``."""
    dist = pairwise_distance(output1, output2)
    return torch.mean((1.0 - label) * dist ** 2
                      + label * torch.clamp(margin - dist, min=0.0) ** 2)
