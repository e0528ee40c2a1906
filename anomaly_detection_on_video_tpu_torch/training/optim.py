"""Optimizers (counterpart of the JAX package's ``training/optim.py``).

The reference trains with ``torch.optim.Adam(lr=1e-3, weight_decay=5e-4)``:
coupled L2, folded into the gradient before the Adam moments (not AdamW).
``adam_with_l2`` keeps the JAX chain's order: clip the raw gradients to a
global norm (optax's ``clip_by_global_norm``), then add ``wd * p``, then
Adam with betas 0.9 / 0.999 and eps 1e-8.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

import torch


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global L2
    norm is at least ``max_norm``, optax's formula (``t / norm * max_norm``;
    ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``).
    Returns the norm before clipping. Decides on the device, no sync."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm.to(g.dtype) * max_norm))
    return norm


class AdamWithL2(torch.optim.Adam):
    """``torch.optim.Adam`` with coupled L2 ``weight_decay``, after an
    optional clip of the raw gradients to the global norm ``grad_clip``.
    The state dict is Adam's whatever the clip, so checkpoints interchange
    across ``grad_clip`` settings, as the JAX chain's do."""

    def __init__(self, params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-3,
                 weight_decay: float = 5e-4, grad_clip: Optional[float] = None):
        super().__init__(params, lr=learning_rate, weight_decay=weight_decay or 0.0)
        self.grad_clip = float(grad_clip) if grad_clip else None

    @torch.no_grad()
    def step(self, closure=None, clip: bool = True):
        """One update; ``clip=False`` skips the clip (the caller clipped
        the gradients these are slices of, ``parallel.ShardedParameters``)."""
        if closure is not None:
            raise ValueError("AdamWithL2 clips the gradients it is given; it takes no closure")
        if self.grad_clip and clip:
            grads = [p.grad for group in self.param_groups for p in group["params"]
                     if p.grad is not None]
            clip_by_global_norm_(grads, self.grad_clip)
        return super().step()


def adam_with_l2(params: Iterable[torch.nn.Parameter], learning_rate: float = 1e-3,
                 weight_decay: float = 5e-4, grad_clip: Optional[float] = None) -> AdamWithL2:
    return AdamWithL2(params, learning_rate, weight_decay, grad_clip)


def build_optimizer(params: Iterable[torch.nn.Parameter], name: str = "adam", **kwargs):
    """``adam`` (``adam_with_l2``), ``adamw`` or ``sgd`` with optax's
    argument names and defaults (``learning_rate``; adamw's
    ``weight_decay`` 1e-4; sgd's ``momentum`` None)."""
    if name == "adam":
        return adam_with_l2(params, **kwargs)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=kwargs.pop("learning_rate"),
                                 weight_decay=kwargs.pop("weight_decay", 1e-4), **kwargs)
    if name == "sgd":
        momentum = kwargs.pop("momentum", None) or 0.0
        return torch.optim.SGD(params, lr=kwargs.pop("learning_rate"), momentum=momentum, **kwargs)
    raise KeyError(f"unknown optimizer {name!r}; options: ['adam', 'adamw', 'sgd']")
