"""Pieces the scorer heads share (MGFN, RTFM, Sultani): the valid-clip
masks of padded-bucket scoring, the train-mode check of ``outputs`` and
the generator-driven dropout, whose masks a data-parallel rank draws at the
global batch's shape."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def clip_masks(
    length: Optional[torch.Tensor], t: int, ncrops: int, device: torch.device
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Valid-clip masks of a clip axis padded to ``t``: ``(video_mask,
    row_mask)``, bool, of shapes (1, t) and (1, t) for a scalar ``length``
    or (bs, t) and (bs * ncrops, t) for a (bs,) vector, where row
    b * ncrops + crop carries video b's clips; ``(None, None)`` without a
    ``length``."""
    if length is None:
        return None, None
    length = torch.as_tensor(length, device=device)
    positions = torch.arange(t, device=device)
    if length.dim() == 0:
        video_mask = (positions < length)[None]
        return video_mask, video_mask
    video_mask = positions[None] < length[:, None]
    return video_mask, video_mask.repeat_interleave(ncrops, dim=0)


def resolve_train(module: torch.nn.Module, train: Optional[bool]) -> bool:
    """``outputs``' ``train`` argument: the module's mode (``.train()`` /
    ``.eval()``) when None; otherwise it must agree with that mode."""
    if train is None:
        return module.training
    if bool(train) != module.training:
        raise ValueError(f"train={train} but the module is in "
                         f"{'train' if module.training else 'eval'} mode")
    return bool(train)


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator],
            shard=None) -> torch.Tensor:
    """flax ``nn.Dropout``'s rule with a mask drawn from ``generator``:
    each element is kept with probability 1 - rate and scaled by
    1 / (1 - rate), else zeroed. Identity at rate 0.

    ``shard`` (a ``parallel.DataShard``): ``x`` is this rank's slice of
    axis 0 of the batch; the mask is drawn at the global batch's shape from
    the generator that every rank seeds alike and sliced, so the ranks
    together drop what one device drops."""
    if rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs an explicit torch.Generator")
    keep_prob = 1.0 - rate
    shape = x.shape if shard is None else (shard.count * x.shape[0], *x.shape[1:])
    keep = torch.rand(shape, generator=generator, device=x.device) < keep_prob
    if shard is not None:
        keep = shard.local(keep)
    return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))
