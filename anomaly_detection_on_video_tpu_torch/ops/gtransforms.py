"""Group video transforms: ten-crop, standardize, loop-pad.

Counterpart of the JAX package's ``ops/gtransforms.py`` (reference
semantics: GroupTenCrop, GroupStandardizationTenCrop and LoopPad). Layout is
channels-last ``(..., H, W, C)`` as in the JAX package. On the extraction
path the crop and the standardization run fused in kernel K1
(``ops/kernels/crop_norm.py``); these functions are its plain building
blocks.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

MEAN = 114.75
STD = 57.375


def ten_crop_positions(height: int, width: int, size: int = 224) -> List[Tuple[int, int]]:
    """torchvision five_crop (top, left) offsets: top-left, top-right,
    bottom-left, bottom-right, center (center rounds like center_crop)."""
    return [
        (0, 0),
        (0, width - size),
        (height - size, 0),
        (height - size, width - size),
        (int(round((height - size) / 2.0)), int(round((width - size) / 2.0))),
    ]


def ten_crop(frames: torch.Tensor, size: int = 224) -> torch.Tensor:
    """``(..., H, W, C) -> (10, ..., size, size, C)``: the five crops of the
    image, then the same five of its horizontal flip (TenCrop order)."""
    height, width = frames.shape[-3], frames.shape[-2]
    positions = ten_crop_positions(height, width, size)
    flipped = torch.flip(frames, dims=(-2,))
    crops = [
        src[..., top: top + size, left: left + size, :]
        for src in (frames, flipped)
        for top, left in positions
    ]
    return torch.stack(crops, dim=0)


def center_crop(frames: torch.Tensor, size: int = 224) -> torch.Tensor:
    """``(..., H, W, C) -> (..., size, size, C)``: crop 4 of ``ten_crop``."""
    height, width = frames.shape[-3], frames.shape[-2]
    top, left = ten_crop_positions(height, width, size)[4]
    return frames[..., top: top + size, left: left + size, :]


def standardize(x: torch.Tensor, mean: float = MEAN, std: float = STD) -> torch.Tensor:
    """``(x - 114.75) * (1 / 57.375)`` in float32.

    A multiply by the float32 reciprocal, not a division: the JAX reference
    computes it so, and bit-equality with it depends on that.
    """
    return (x.to(torch.float32) - mean) * (1.0 / std)


def loop_pad_indices(n_frames: int, frames_per_clip: int = 16) -> np.ndarray:
    """``(n_clips, frames_per_clip)`` frame indices: non-overlapping clips,
    a short final clip loop-padded with its own frames (tail[i % L])."""
    n_clips = (n_frames - 1) // frames_per_clip + 1
    idx = np.zeros((n_clips, frames_per_clip), dtype=np.int32)
    for clip in range(n_clips):
        start = clip * frames_per_clip
        length = min(frames_per_clip, n_frames - start)
        for i in range(frames_per_clip):
            idx[clip, i] = start + (i % length)
    return idx
