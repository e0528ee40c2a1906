"""K1: ten-crop + standardize, resized uint8 frames -> the I3D input batch.

Replaces ``ten_crop_standardize_pallas`` (anomaly_detection_on_video_tpu/
ops/pallas/crop_norm.py:49). ``(gc, fpc, H, W, 3)`` uint8 ->
``(gc*10, fpc, S, S, 3)`` float32 or bfloat16, batch row ``clip*10 + crop``.

On the H100 it is bound by memory: each output value is written once (4 or
2 bytes) from one uint8 read. The CUDA kernel (``csrc/crop_norm.cu``) runs
one thread per output pixel and does the flip by index arithmetic, so
neither the flipped copy nor the float ten-crop expansion of the plain
version is ever materialized. Its float32 output is bit-equal to the plain
version's.
"""

from __future__ import annotations

import ctypes

import torch

from ..gtransforms import MEAN, STD, standardize, ten_crop, ten_crop_positions

_MAX_PLANES = 65535  # grid.y limit of the launch: gc * 10 * fpc planes


def ten_crop_standardize_plain(
    frames: torch.Tensor, cropsize: int = 224, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain version: slicing + flip, standardize, (clip, crop) batch order."""
    gc, fpc = frames.shape[:2]
    crops = ten_crop(frames, cropsize)  # (10, gc, fpc, S, S, 3) uint8
    x = standardize(crops).to(dtype)
    return x.transpose(0, 1).reshape(gc * 10, fpc, cropsize, cropsize, frames.shape[-1])


def ten_crop_standardize(
    frames: torch.Tensor, cropsize: int = 224, dtype: torch.dtype = torch.bfloat16
) -> torch.Tensor:
    """``(gc, fpc, H, W, 3)`` uint8 -> ``(gc*10, fpc, S, S, 3)`` ``dtype``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if frames.dtype != torch.uint8 or frames.dim() != 5 or frames.shape[-1] != 3:
        raise ValueError(f"expected (gc, fpc, H, W, 3) uint8 frames, got {tuple(frames.shape)} {frames.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"output dtype must be float32 or bfloat16, got {dtype}")
    gc, fpc, height, width, _ = frames.shape
    if min(height, width) < cropsize:
        raise ValueError(f"frames {height}x{width} are smaller than the {cropsize} crop")
    if frames.device.type == "cpu":
        return ten_crop_standardize_plain(frames, cropsize, dtype)
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if gc * 10 * fpc > _MAX_PLANES:
        raise ValueError(f"gc * 10 * fpc = {gc * 10 * fpc} exceeds {_MAX_PLANES}")
    from ._build import build, current_stream

    lib = build()
    out = torch.empty((gc * 10, fpc, cropsize, cropsize, 3), dtype=dtype, device=frames.device)
    positions = ten_crop_positions(height, width, cropsize)
    offsets = (ctypes.c_int * 10)(*[t for t, _ in positions], *[l for _, l in positions])
    lib.call(
        "adv_crop_norm", frames.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16),
        gc, fpc, height, width, cropsize, offsets, MEAN, 1.0 / STD,
        current_stream(frames),
    )
    ten_crop_standardize.launches += 1
    return out


ten_crop_standardize.launches = 0
