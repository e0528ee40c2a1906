"""The combined MGFN training loss (counterpart of the JAX package's
``losses/mgfn.py``):

    loss = BCE(normal ‖ abnormal top-k scores, labels)
         + α * (α * loss_con + loss_con_a + loss_con_n),   α = 0.001

The double-α weighting of the separation term is the reference's, kept
verbatim. The contrastive terms act on the L1 norms of the selected top-k
feature rows: normal against abnormal (label 1), and each half against its
other half (label 0).
"""

from __future__ import annotations

import torch

from .base import contrastive_loss


class _BCE(torch.autograd.Function):
    """torch ``BCELoss``'s forward and backward. The backward is the
    reference's, ``(p - y) / max(p (1 - p), 1e-12)``: autograd through the
    clamped logs (the JAX package's formula) gives ``0 * inf = NaN`` where
    a probability is exactly 0 or 1, which a confident scorer reaches in
    float32 (a logit above about 17)."""

    @staticmethod
    def forward(ctx, probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(probs, labels)
        log_p = torch.clamp(torch.log(probs), min=-100.0)
        log_1p = torch.clamp(torch.log1p(-probs), min=-100.0)
        return -torch.mean(labels * log_p + (1.0 - labels) * log_1p)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        probs, labels = ctx.saved_tensors
        dp = (probs - labels) / torch.clamp(probs * (1.0 - probs), min=1e-12)
        return (grad * dp / probs.numel()).to(probs.dtype), None


def bce_loss(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """torch ``BCELoss``: mean of -(y log p + (1 - y) log(1 - p)), each log
    term clamped at -100, with ``BCELoss``'s gradient (finite at p = 0 and
    1; ``_BCE``)."""
    return _BCE.apply(probs, labels)


def mgfn_loss(
    abnormal_scores: torch.Tensor,  # (bs//2, 1)
    normal_scores: torch.Tensor,  # (bs//2, 1)
    a_feat_magnitude: torch.Tensor,  # (bs//2 * ncrops, k, f)
    n_feat_magnitude: torch.Tensor,  # (bs//2 * ncrops, k, f)
    abnormal_labels: torch.Tensor,  # (bs//2,)
    normal_labels: torch.Tensor,  # (bs//2,)
    alpha: float = 0.001,
) -> torch.Tensor:
    labels = torch.cat([normal_labels, abnormal_labels], dim=0)
    scores = torch.cat([normal_scores, abnormal_scores], dim=0).squeeze()
    separate = len(n_feat_magnitude) // 2

    loss_cls = bce_loss(scores, labels)
    a_l1 = torch.linalg.vector_norm(a_feat_magnitude, ord=1, dim=2)
    n_l1 = torch.linalg.vector_norm(n_feat_magnitude, ord=1, dim=2)
    loss_con = contrastive_loss(a_l1, n_l1, 1.0)
    loss_con_n = contrastive_loss(n_l1[separate:], n_l1[:separate], 0.0)
    loss_con_a = contrastive_loss(a_l1[separate:], a_l1[:separate], 0.0)

    loss_contrastive = alpha * loss_con + loss_con_a + loss_con_n
    return loss_cls + alpha * loss_contrastive
