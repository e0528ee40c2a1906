"""Bit-exact PIL bilinear resize as two float32 matmuls.

Counterpart of the JAX package's ``ops/resize.py``. The reference resizes
every frame with ``transforms.Resize(256, BILINEAR)`` on PIL images: a
horizontal pass rounded to uint8, then a vertical pass rounded to uint8,
with triangle-filter weights quantized to 2^-22 fixed point (Pillow
``Resample.c``). Each pass here is a dense (out, in) coefficient matrix.

The exact path splits each 22-bit weight into an 11-bit high and low half.
Every product and every partial sum of either half is then an integer below
2^24, so float32 matmuls are exact in any summation order (torch has no
integer matmul on CUDA); the int32 recombination reproduces Pillow's
add-half-and-shift rounding bit for bit. TF32 must be off on the card
(``utils.device.set_f32_parity``): the functions below also force it off for
their own matmuls.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..utils.device import full_f32

# Pillow Resample.c fixed-point precision for 8-bit images.
PRECISION_BITS = 32 - 8 - 2
_LO_BITS = 11  # 2^22 fixed-point weights split into two <= 11-bit halves


def short_side_size(height: int, width: int, size: int = 256) -> Tuple[int, int]:
    """torchvision ``Resize(int)`` target: scale so the short side == size,
    truncating the long side to int as torchvision does."""
    if height <= width:
        return size, int(size * width / height)
    return int(size * height / width), size


@functools.lru_cache(maxsize=256)
def pil_resize_coeffs(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) int32 fixed-point triangle-filter matrix:
    Pillow's ``precompute_coeffs`` for BILINEAR (support 1.0), normalized in
    double precision then quantized to round(w * 2^22)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    matrix = np.zeros((out_size, in_size), dtype=np.int32)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        n = xmax - xmin
        w = np.empty(n, dtype=np.float64)
        for i in range(n):
            x = (xmin + i + 0.5 - center) / filterscale
            w[i] = max(0.0, 1.0 - abs(x))
        w /= w.sum()
        matrix[xx, xmin:xmax] = np.round(w * (1 << PRECISION_BITS)).astype(np.int32)
    return matrix


def _matmul_pass(x: torch.Tensor, w: torch.Tensor, axis: str) -> torch.Tensor:
    """Resample ``x`` (..., H, W, C) along W (axis "w") or H (axis "h") with
    the (out, in) matrix ``w``, in full float32."""
    with full_f32():
        if axis == "w":
            return torch.einsum("...hwc,vw->...hvc", x, w)
        return torch.einsum("...hwc,vh->...vwc", x, w)


def _exact_pass(x: torch.Tensor, wq: np.ndarray, axis: str) -> torch.Tensor:
    hi = torch.from_numpy((wq >> _LO_BITS).astype(np.float32)).to(x.device)
    lo = torch.from_numpy((wq & ((1 << _LO_BITS) - 1)).astype(np.float32)).to(x.device)
    p_hi = _matmul_pass(x, hi, axis).to(torch.int32)
    p_lo = _matmul_pass(x, lo, axis).to(torch.int32)
    acc = p_hi * (1 << _LO_BITS) + p_lo
    half = 1 << (PRECISION_BITS - 1)
    return torch.clamp((acc + half) >> PRECISION_BITS, 0, 255).to(torch.float32)


def resize_bilinear_exact(frames: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """uint8 ``(..., H, W, C)`` -> uint8 ``(..., out_h, out_w, C)``,
    bit-identical to PIL BILINEAR (horizontal pass first, like Pillow)."""
    in_h, in_w = frames.shape[-3], frames.shape[-2]
    x = frames.to(torch.float32)
    x = _exact_pass(x, pil_resize_coeffs(in_w, out_w), "w")
    x = _exact_pass(x, pil_resize_coeffs(in_h, out_h), "h")
    return x.to(torch.uint8)


def _banded_pass(x: torch.Tensor, wq: np.ndarray, dim: int, fused: bool) -> torch.Tensor:
    """One float32 pass with Pillow's quantized coefficients: each output
    sums its window of taps in order, either as a rounded product plus a
    rounded add (``fused=False``) or as one fused multiply-add per tap,
    emulated exactly in float64 (products of a uint8 value and a 22-bit
    weight plus a sum below 256 fit in 53 bits). Independent of any BLAS,
    so the CPU and the card give the same pixels."""
    nonzero = wq != 0
    first = nonzero.argmax(axis=1)
    last = wq.shape[1] - 1 - nonzero[:, ::-1].argmax(axis=1)
    taps = int((last - first).max()) + 1
    idx = first[:, None] + np.arange(taps)[None]
    valid = idx <= last[:, None]
    idx = np.minimum(idx, wq.shape[1] - 1)
    w = np.where(valid, np.take_along_axis(wq, idx, axis=1), 0).astype(np.float32)
    w *= np.float32(1.0 / (1 << PRECISION_BITS))
    idx_t = torch.from_numpy(idx).to(x.device)
    w_t = torch.from_numpy(w).to(x.device)
    view = (-1,) + (1,) * (-dim - 1)  # broadcast the weights along ``dim``
    acc = None
    for j in range(taps):
        src = x.index_select(dim, idx_t[:, j])
        w_j = w_t[:, j].view(view)
        if fused:
            prev = 0.0 if acc is None else acc.double()
            acc = (src.double() * w_j.double() + prev).float()
        else:
            term = src * w_j
            acc = term if acc is None else acc + term
    return torch.clamp(torch.floor(acc + 0.5), 0.0, 255.0)


def resize_bilinear_fast(frames: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Near-exact PIL resize in float32 with Pillow's quantized
    coefficients and round-half-up between passes. Float rounding can
    misround a pixel whose exact value lies next to an x.5 boundary, always
    by one LSB. The horizontal pass rounds each product and each add, the
    vertical pass fuses them: the orders the JAX reference's CPU matmuls
    take on 240x320 and 320x240 frames, where the two agree bit for bit."""
    in_h, in_w = frames.shape[-3], frames.shape[-2]
    x = frames.to(torch.float32)
    x = _banded_pass(x, pil_resize_coeffs(in_w, out_w), -2, fused=False)
    x = _banded_pass(x, pil_resize_coeffs(in_h, out_h), -3, fused=True)
    return x.to(torch.uint8)
