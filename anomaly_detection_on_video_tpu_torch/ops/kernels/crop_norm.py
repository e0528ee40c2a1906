"""K1: ten-crop + standardize, resized uint8 frames -> the I3D input batch.

Replaces ``ten_crop_standardize_pallas`` (anomaly_detection_on_video_tpu/
ops/pallas/crop_norm.py:49). ``(gc, fpc, H, W, 3)`` uint8 ->
``(gc*10, fpc, S, S, 3)`` float32 or bfloat16, batch row ``clip*10 + crop``.

On the H100 it is bound by memory: each output value is written once (4 or
2 bytes) from one uint8 read. The CUDA kernel (``csrc/crop_norm.cu``) gives
each CTA one (clip, frame) and a band of output rows of all ten crops. It
stages the input the band needs (at most five segments: runs of rows, each
over the span of columns its crops read) into shared memory once, converts
eight output pixels per thread step, the flips by reading the staged row in
reverse, and writes each warp's 16-byte vectors as whole contiguous runs.
``crop_norm_plan`` lays the launch out on the host, once per frame
geometry; the CPU tests evaluate the same plan. Its float32 output is
bit-equal to the plain version's, and its bfloat16 output is that value
rounded to nearest even.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ..gtransforms import MEAN, STD, standardize, ten_crop, ten_crop_positions

# the kernel's constants (csrc/crop_norm.cu)
THREADS = 256
GROUP = 8  # output pixels a thread converts per step: 24 values, read as 7 words
PAD = 32  # shared bytes before and after the staged rows, for the 7-word windows
MAX_SHARED = 232_448  # dynamic shared memory a CTA may use on the H100 (227 KB)
MAX_CTAS = 2 ** 31 - 1  # grid.x limit of the launch: gc * fpc * n_bands CTAs
MAX_SEGMENTS = 5  # staged segments: one per crop position at most


class CropNormPlan(NamedTuple):
    """K1's launch plan for one (H, W, S) and output type.

    A CTA owns output rows ``y0 .. y0 + band`` of one (clip, frame), for all
    ten crops. Segment ``s`` holds input rows ``y0 + segments[s][0] ..
    y0 + segments[s][1]`` (clamped to H), columns ``columns[s][0] ..
    columns[s][1]``, at ``seg_offset[s]`` in shared memory. A segment of
    whole rows (every segment of a frame whose crop windows cover its width)
    is copied as one run from its first byte rounded down to 16, so its row
    j starts at ``seg_offset[s] + (address % 16) + j * W * 3``; otherwise
    each row is copied from its own first byte rounded down to 16 into a
    slot of ``pitch[s]`` bytes, and starts at ``seg_offset[s] + j *
    pitch[s] + (its address % 16)``. Crop position k reads segment
    ``crop_segment[k]``, its flip segment ``flip_segment[k]``, from row
    ``crop_row[k]`` on.
    """

    band: int
    n_bands: int
    tops: Tuple[int, ...]  # the distinct crop tops
    segments: Tuple[Tuple[int, int], ...]  # rows, relative to the band's first
    columns: Tuple[Tuple[int, int], ...]
    pitch: Tuple[int, ...]  # shared bytes a staged row takes
    seg_offset: Tuple[int, ...]
    crop_segment: Tuple[int, ...]
    flip_segment: Tuple[int, ...]
    crop_row: Tuple[int, ...]
    lefts: Tuple[int, ...]
    stage_offset: int  # the warps' output staging (vector mode)
    shared_bytes: int
    vector: bool  # 16-byte stores: every crop row is whole 16-byte vectors
    whole_rows: bool  # every segment is whole rows, staged as one run

    def ints(self) -> list:
        """The plan as the kernel's ``struct Plan`` lays it out (57 ints)."""
        def pad(xs):
            xs = list(xs)
            return xs + [0] * (MAX_SEGMENTS - len(xs))

        return [self.band, self.n_bands, len(self.segments),
                *pad(lo for lo, _ in self.segments), *pad(hi for _, hi in self.segments),
                *pad(lo for lo, _ in self.columns), *pad(hi for _, hi in self.columns),
                *pad(self.pitch), *pad(self.seg_offset), *self.crop_segment,
                *self.flip_segment, *self.crop_row, *self.lefts, self.stage_offset,
                self.shared_bytes, int(self.vector), int(self.whole_rows)]


def _segment_capacity(rows: int, row_bytes: int) -> int:
    """Shared bytes for ``rows`` rows copied in 16-byte pieces from any
    start alignment: up to 15 bytes precede the first row."""
    return -(-(15 + rows * row_bytes) // 16) * 16


def _merge(runs):
    """Sorted runs ``(lo, hi)`` with those that touch or overlap merged."""
    merged = []
    for lo, hi in sorted(runs):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _windows(positions, width: int, size: int, tops) -> list:
    """The merged column windows that the crops with a top in ``tops`` read,
    their flips included (a flip at ``left`` reads ``W - left - S ..
    W - left``)."""
    return _merge(w for top, left in positions if top in tops
                  for w in ((left, left + size), (width - left - size, width - left)))


def _layout(positions, width: int, size: int, band: int, out_bytes: int) -> CropNormPlan:
    tops = sorted({top for top, _ in positions})
    row_bytes = width * 3
    # a frame whose crop windows together cover its width stages whole rows;
    # one whose crops leave gaps stages each run of rows over its crops' columns only
    whole = _windows(positions, width, size, tops) == [(0, width)]
    segments, columns, pitch, offsets, at = [], [], [], [], PAD
    for lo, hi in _merge((top, top + band) for top in tops):
        spans = [(0, width)] if whole else _windows(
            positions, width, size, [t for t in tops if lo <= t < hi])
        for c0, c1 in spans:
            segments.append((lo, hi))
            columns.append((c0, c1))
            offsets.append(at)
            if whole:
                pitch.append(row_bytes)
                at += _segment_capacity(hi - lo, row_bytes)
            else:  # each row in a 16-byte-aligned slot, up to 15 bytes before its first
                pitch.append(_segment_capacity(1, (c1 - c0) * 3))
                at += (hi - lo) * pitch[-1]
    stage_offset = at + PAD
    vector = size % GROUP == 0
    stage = THREADS * GROUP * 3 * out_bytes if vector else 0  # each lane's 24 values

    def segment_of(top, c0, c1):
        return next(s for s, ((lo, hi), (a, b)) in enumerate(zip(segments, columns))
                    if lo <= top < hi and a <= c0 and c1 <= b)

    crop_segment = [segment_of(top, left, left + size) for top, left in positions]
    flip_segment = [segment_of(top, width - left - size, width - left)
                    for top, left in positions]
    crop_row = [top - segments[s][0] for (top, _), s in zip(positions, crop_segment)]
    return CropNormPlan(band, -(-size // band), tuple(tops), tuple(segments), tuple(columns),
                        tuple(pitch), tuple(offsets), tuple(crop_segment), tuple(flip_segment),
                        tuple(crop_row), tuple(left for _, left in positions), stage_offset,
                        stage_offset + stage, vector, whole)


@functools.lru_cache(maxsize=64)
def crop_norm_plan(height: int, width: int, size: int, dtype: torch.dtype = torch.bfloat16,
                   shared_budget: int = MAX_SHARED) -> CropNormPlan:
    """The launch plan of K1 for ``(H, W)`` frames, ``size`` crops, and
    ``dtype`` output: the tallest band whose staged input fits
    ``shared_budget`` bytes, then the bands evened out over the ``size``
    rows.

    The default takes all of a CTA's shared memory, so one CTA runs per
    SM: a taller band stages fewer input rows twice (a band of b rows of
    256x341 frames stages b + 32), and on the H100 that gains more than
    several CTAs per SM overlapping their staging (``chip_smoke.py`` times
    the bulk shape across budgets). A frame of any width fits: where its
    crops leave columns between them unread, a staged row holds at most
    five spans of ``size`` pixels (one per crop position)."""
    if min(height, width) < size:
        raise ValueError(f"frames {height}x{width} are smaller than the {size} crop")
    positions = ten_crop_positions(height, width, size)
    out_bytes = torch.empty((), dtype=dtype).element_size()
    band = next((b for b in range(size, 0, -1) if _layout(
        positions, width, size, b, out_bytes).shared_bytes <= shared_budget), None)
    if band is None:
        raise ValueError(f"a {size} crop: one band row of frames {height}x{width} does not fit "
                         f"{shared_budget} bytes of shared memory")
    band = -(-size // -(-size // band))  # the same number of bands, evened out
    return _layout(positions, width, size, band, out_bytes)


def ten_crop_standardize_plain(
    frames: torch.Tensor, cropsize: int = 224, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain version: slicing + flip, standardize, (clip, crop) batch order."""
    gc, fpc = frames.shape[:2]
    crops = ten_crop(frames, cropsize)  # (10, gc, fpc, S, S, 3) uint8
    x = standardize(crops).to(dtype)
    return x.transpose(0, 1).reshape(gc * 10, fpc, cropsize, cropsize, frames.shape[-1])


@functools.lru_cache(maxsize=64)
def _plan_array(height: int, width: int, size: int, dtype: torch.dtype):
    ints = crop_norm_plan(height, width, size, dtype).ints()
    return (ctypes.c_int * len(ints))(*ints)


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
    plan = crop_norm_plan(height, width, cropsize, dtype)
    if gc * fpc * plan.n_bands > MAX_CTAS:
        raise ValueError(f"gc * fpc * {plan.n_bands} bands = {gc * fpc * plan.n_bands} CTAs "
                         f"exceed {MAX_CTAS}")
    from ._build import build, current_stream

    lib = build()
    out = torch.empty((gc * 10, fpc, cropsize, cropsize, 3), dtype=dtype, device=frames.device)
    lib.call(
        "adv_crop_norm", frames.data_ptr(), out.data_ptr(), int(dtype == torch.bfloat16),
        gc, fpc, height, width, cropsize, _plan_array(height, width, cropsize, dtype),
        MEAN, 1.0 / STD, current_stream(frames),
    )
    ten_crop_standardize.launches += 1
    return out


ten_crop_standardize.launches = 0
