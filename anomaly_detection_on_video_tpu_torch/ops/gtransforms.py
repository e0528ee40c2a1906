"""Group video transforms: ten-crop, center crop, standardize, loop-pad,
the whole-video preprocess and the reference's min-max alternatives.

Counterpart of the JAX package's ``ops/gtransforms.py`` (reference
semantics: GroupTenCrop, GroupStandardizationTenCrop, LoopPad,
GroupPixelMinmaxTenCrop and GroupRGBChannelMinmaxTenCrop). Layout is
channels-last ``(..., H, W, C)`` as in the JAX package. On the ten-crop
extraction path the crop and the standardization run fused in kernel K1
(``ops/kernels/crop_norm.py``); these functions are its plain building
blocks. The center-crop path runs ``center_crop`` and ``standardize`` as
they are, as the JAX package runs them through XLA.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from .resize import resize_bilinear_exact, short_side_size

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


def preprocess_frames(
    frames: Union[np.ndarray, torch.Tensor],
    resize: int = 256,
    cropsize: int = 224,
    frames_per_clip: int = 16,
) -> torch.Tensor:
    """Whole-video preprocessing, the reference's five-stage Compose: uint8
    ``(n_frames, H, W, 3)`` -> float32 ``(n_clips, 10, frames_per_clip,
    cropsize, cropsize, 3)``, exactly resized (short side ``resize``),
    ten-cropped, loop-padded and standardized, on the frames' device."""
    frames = torch.as_tensor(frames)
    n_frames, height, width = frames.shape[:3]
    out_h, out_w = short_side_size(height, width, resize)
    crops = ten_crop(resize_bilinear_exact(frames, out_h, out_w), cropsize)  # (10, n, c, c, 3)
    clip_idx = torch.from_numpy(loop_pad_indices(n_frames, frames_per_clip).astype(np.int64))
    clips = standardize(crops[:, clip_idx.to(frames.device)])  # (10, n_clips, fpc, c, c, 3)
    return clips.transpose(0, 1)


def pixel_minmax(x: torch.Tensor, new_min: float = 0.0, new_max: float = 1.0) -> torch.Tensor:
    """Min-max normalization over all pixels of each ``(..., H, W, C)``
    image (the reference's unused GroupPixelMinmaxTenCrop), in float32."""
    lo = torch.amin(x, dim=(-3, -2, -1), keepdim=True)
    hi = torch.amax(x, dim=(-3, -2, -1), keepdim=True)
    x = (x.to(torch.float32) - lo) / (hi - lo)
    return x * (new_max - new_min) + new_min


def rgb_channel_minmax(x: torch.Tensor, new_min: float = 0.0, new_max: float = 1.0) -> torch.Tensor:
    """Per-channel min-max normalization of each ``(..., H, W, C)`` image
    (the reference's GroupRGBChannelMinmaxTenCrop), in float32."""
    lo = torch.amin(x, dim=(-3, -2), keepdim=True)
    hi = torch.amax(x, dim=(-3, -2), keepdim=True)
    x = (x.to(torch.float32) - lo) / (hi - lo)
    return x * (new_max - new_min) + new_min
