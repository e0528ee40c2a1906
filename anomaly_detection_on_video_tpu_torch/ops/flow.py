"""Dense optical flow on the device: Farneback polynomial expansion.

Counterpart of the JAX package's ``ops/flow.py`` (which runs through XLA,
with no Pallas kernel), so it ports as torch ops: quadratic polynomial
expansion (``poly_expansion``), Farneback's displacement update at fixed
expansions (``_flow_iteration``) and a three-level pyramid with
level-dependent iteration counts (``ITERATIONS``), then the host path's
truncate-to-[-20, 20] / scale-to-[-1, 1] (``data/flow.py``).

Layouts are the JAX package's: frames ``(B, H, W)``, fields
``(B, H, W, C)``. The separable filters are depthwise ``conv2d`` calls
(one group per frame and channel) over edge-replicated
(``F.pad(mode="replicate")``) inputs, output channels kernel-major per
input channel; the bilinear warp is an explicit gather on
the flattened field with the JAX function's clamps (``grid_sample`` rescales
coordinates to [-1, 1] and back, which rounds differently); the pyramid's
x2 upsample is ``F.interpolate(bilinear, align_corners=False)``, which
agrees with ``jax.image.resize`` at even and odd sizes.

Flows are float32 whatever dtype the extractor's model uses, with TF32 off
(``utils.device.full_f32``): cuDNN convolutions default to TF32 on the card.
A chunk's frame pairs go through ``_flow_pair_batch`` in sub-batches of
``FLOW_PAIRS`` pairs that overlap by one frame: pairs are independent, so
the result is the whole chunk's, and the device holds one sub-batch's
intermediates instead of a 3,008-frame chunk's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..data.flow import FLOW_BOUND
from ..utils.device import full_f32

POLY_N = 5
POLY_SIGMA = 1.2
WINSIZE = 15
LEVELS = 3
# iterations per level, fine -> coarse (the JAX package's schedule)
ITERATIONS = (1, 2, 3)
PYR_SCALE = 0.5
# frame pairs per sub-batch of compute_flow_device / compute_flow_tvl1. On
# an H100 at 240x320 a pair holds about 27 MiB of Farneback intermediates
# (3.40 GiB at 128 pairs) and 22 MiB of TV-L1's (2.75 GiB); Farneback's
# time per frame is flat from 128 pairs, TV-L1's falls with the batch (it
# is launch-bound), so 256 pairs keep a 3,008-frame chunk near 7 GiB
# (PERF.md, the flow section; chip_smoke.py phase 11)
FLOW_PAIRS = 256


def _poly_basis(n: int = POLY_N, sigma: float = POLY_SIGMA):
    """Separable filters and the inverse normal matrix of the quadratic
    expansion: weighted least squares over the (2n+1)^2 window with weight
    g(x)g(y), basis (1, x, y, x^2, y^2, xy)."""
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    k0, k1, k2 = g, x * g, (x ** 2) * g

    xs, ys = np.meshgrid(x, x, indexing="xy")
    w = np.outer(g, g)
    phi = np.stack([np.ones_like(xs), xs, ys, xs ** 2, ys ** 2, xs * ys])
    G = np.einsum("ihw,jhw,hw->ij", phi, phi, w)
    G_inv = np.linalg.inv(G)
    kernels = np.stack([k0, k1, k2]).astype(np.float32)  # (3, 2n+1)
    return kernels, G_inv.astype(np.float32)


_POLY_K, _G_INV = _poly_basis()
_BOX = np.ones((1, WINSIZE), np.float32) / WINSIZE
_G5 = np.asarray([[1, 4, 6, 4, 1]], np.float32) / 16


def _conv_axis(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Correlate ``(B, H, W, C)`` along one spatial axis (0: H, 1: W) with
    edge replication. ``taps`` is ``(n_k, k)``: every input channel is
    correlated with every kernel -> ``(B, H, W, C * n_k)``, channel
    ``c * n_k + j`` for input channel c and kernel j."""
    n_k, k = taps.shape
    b, h, w, c = x.shape
    half = (k - 1) // 2
    # every (frame, channel) plane is a group of one depthwise conv: each
    # plane's sums then do not depend on how many frames share the call
    # (on the card the native depthwise kernel, exact float32 at any TF32
    # setting); a lone plane gets a zero partner, as one group is no
    # depthwise conv
    planes = x.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    if b * c == 1:
        planes = torch.cat([planes, torch.zeros_like(planes)], dim=1)
    groups = planes.shape[1]
    xp = F.pad(planes, (0, 0, half, half) if axis == 0 else (half, half, 0, 0), mode="replicate")
    kern = torch.from_numpy(np.ascontiguousarray(taps)).to(x.device)
    kern = kern.reshape(n_k, 1, k, 1) if axis == 0 else kern.reshape(n_k, 1, 1, k)
    out = F.conv2d(xp, kern.repeat(groups, 1, 1, 1), groups=groups)  # (1, groups * n_k, h, w)
    return out[:, :b * c * n_k].reshape(b, c * n_k, h, w).permute(0, 2, 3, 1)


def poly_expansion(img: torch.Tensor):
    """``(B, H, W)`` -> (b ``(B, H, W, 2)``, A ``(B, H, W, 2, 2)``)."""
    rows = _conv_axis(img[..., None], _POLY_K, 0)  # (B,H,W,3): g, yg, y2g
    moms = _conv_axis(rows, _POLY_K, 1)  # (B,H,W,9): moms[..., q*3 + p]
    m = {(p, q): moms[..., q * 3 + p] for p in range(3) for q in range(3)}
    rhs = torch.stack([m[(0, 0)], m[(1, 0)], m[(0, 1)], m[(2, 0)], m[(0, 2)], m[(1, 1)]], dim=-1)
    coef = rhs @ torch.from_numpy(np.ascontiguousarray(_G_INV.T)).to(img.device)
    b = coef[..., 1:3]
    A = torch.stack([torch.stack([coef[..., 3], coef[..., 5] / 2], dim=-1),
                     torch.stack([coef[..., 5] / 2, coef[..., 4]], dim=-1)], dim=-2)
    return b, A


def _bilinear_warp(field: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Sample ``field`` ``(B, H, W, C)`` at x + flow (``(dx, dy)``),
    coordinates clamped to the frame, by a gather on the flattened field."""
    bsz, h, w = field.shape[:3]
    dev = field.device
    ys = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] + flow[..., 1]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] + flow[..., 0]
    ys = torch.clamp(ys, 0.0, h - 1.0)
    xs = torch.clamp(xs, 0.0, w - 1.0)
    y0 = torch.clamp(torch.floor(ys), 0, h - 2).to(torch.int64)
    x0 = torch.clamp(torch.floor(xs), 0, w - 2).to(torch.int64)
    fy = (ys - y0)[..., None]
    fx = (xs - x0)[..., None]
    flat = field.reshape(bsz * h * w, -1)
    idx = torch.arange(bsz, dtype=torch.int64, device=dev)[:, None, None] * (h * w) + y0 * w + x0

    def take(offset: int) -> torch.Tensor:
        return flat.index_select(0, (idx + offset).reshape(-1)).reshape(bsz, h, w, -1)

    f00, f01, f10, f11 = take(0), take(1), take(w), take(w + 1)
    return (f00 * (1 - fy) * (1 - fx) + f01 * (1 - fy) * fx
            + f10 * fy * (1 - fx) + f11 * fy * fx)


def _box_blur(x: torch.Tensor) -> torch.Tensor:
    """``(B, H, W, C)`` uniform WINSIZE box filter over both axes."""
    return _conv_axis(_conv_axis(x, _BOX, 0), _BOX, 1)


def _flow_iteration(b1, A1, b2, A2, flow):
    """One Farneback displacement update at fixed expansions."""
    bsz, h, w = flow.shape[:3]
    warped = _bilinear_warp(torch.cat([b2, A2.reshape(bsz, h, w, 4)], dim=-1), flow)
    b2w = warped[..., :2]
    A2w = warped[..., 2:].reshape(bsz, h, w, 2, 2)
    A = 0.5 * (A1 + A2w)
    f0, f1 = flow[..., 0], flow[..., 1]
    a00, a01, a10, a11 = A[..., 0, 0], A[..., 0, 1], A[..., 1, 0], A[..., 1, 1]
    db = -0.5 * (b2w - b1) + torch.stack([a00 * f0 + a01 * f1, a10 * f0 + a11 * f1], dim=-1)
    d0, d1 = db[..., 0], db[..., 1]
    # the 2x2 normal equations, aggregated over the window: the five
    # unique quantities in one blurred tensor
    packed = _box_blur(torch.stack([
        a00 ** 2 + a10 ** 2,
        a00 * a01 + a10 * a11,
        a01 ** 2 + a11 ** 2,
        a00 * d0 + a10 * d1,
        a01 * d0 + a11 * d1,
    ], dim=-1))
    g00, g01, g11, h0, h1 = packed.unbind(-1)
    det = g00 * g11 - g01 * g01
    det = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
    return torch.stack([(g11 * h0 - g01 * h1) / det, (g00 * h1 - g01 * h0) / det], dim=-1)


def _downsample(img: torch.Tensor) -> torch.Tensor:
    """``(B, H, W)``: [1 4 6 4 1] / 16 blur, then keep every other row and
    column (a pyramid level)."""
    blurred = _conv_axis(_conv_axis(img[..., None], _G5, 0), _G5, 1)
    return blurred[:, ::2, ::2, 0]


def _upsample_flow(flow: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``(B, h, w, 2)`` -> ``(B, height, width, 2)`` by bilinear
    resampling (half-pixel centers), scaled by 1 / PYR_SCALE: the
    pyramid's step to the next finer level."""
    up = F.interpolate(flow.permute(0, 3, 1, 2), size=(height, width), mode="bilinear",
                       align_corners=False)
    return up.permute(0, 2, 3, 1) / PYR_SCALE


def _flow_pair_batch(prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """Dense flow for grayscale pairs ``(B, H, W)`` -> ``(B, H, W, 2)`` px."""
    pyr_prev, pyr_cur = [prev], [cur]
    for _ in range(LEVELS - 1):
        pyr_prev.append(_downsample(pyr_prev[-1]))
        pyr_cur.append(_downsample(pyr_cur[-1]))

    flow = torch.zeros((*pyr_prev[-1].shape, 2), dtype=torch.float32, device=prev.device)
    for level in reversed(range(LEVELS)):
        p, c = pyr_prev[level], pyr_cur[level]
        if flow.shape[1:3] != p.shape[1:3]:
            flow = _upsample_flow(flow, *p.shape[1:3])
        b1, A1 = poly_expansion(p)
        b2, A2 = poly_expansion(c)
        for _ in range(ITERATIONS[level]):
            flow = _flow_iteration(b1, A1, b2, A2, flow)
    return flow


def gray(frames: torch.Tensor) -> torch.Tensor:
    """uint8 RGB ``(N, H, W, 3)`` -> float32 ``(N, H, W)`` ITU-R BT.601
    luma in [0, 255] (cv2.cvtColor's RGB2GRAY weights, unrounded)."""
    rgb = frames.to(torch.float32)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def flow_over_pairs(frames: torch.Tensor, pair_batch: Callable,
                    pairs: int = FLOW_PAIRS) -> torch.Tensor:
    """uint8 RGB ``(N, H, W, 3)`` -> float32 ``(N, H, W, 2)`` in [-1, 1] on
    ``frames``' device: ``pair_batch`` over consecutive gray pairs, in
    sub-batches of ``pairs`` pairs overlapping by one frame; frame 0 gets
    zero flow; truncation to [-FLOW_BOUND, FLOW_BOUND], scaled to [-1, 1]."""
    if frames.dim() != 4 or frames.shape[-1] != 3 or frames.dtype != torch.uint8:
        raise ValueError(f"expected uint8 (N, H, W, 3) frames, got {frames.dtype} "
                         f"{tuple(frames.shape)}")
    if pairs < 1:
        raise ValueError(f"pairs must be >= 1, got {pairs}")
    n = frames.shape[0]
    out = torch.zeros((n, *frames.shape[1:3], 2), dtype=torch.float32, device=frames.device)
    with torch.no_grad(), full_f32():
        for start in range(0, n - 1, pairs):
            stop = min(start + pairs, n - 1)  # pairs start .. stop - 1
            g = gray(frames[start:stop + 1])
            flow = pair_batch(g[:-1], g[1:])
            out[start + 1:stop + 1] = torch.clamp(flow, -FLOW_BOUND, FLOW_BOUND) / FLOW_BOUND
    return out


def compute_flow_device(frames: torch.Tensor, pairs: int = FLOW_PAIRS) -> torch.Tensor:
    """uint8 RGB ``(N, H, W, 3)`` -> float32 Farneback flow ``(N, H, W, 2)``
    in [-1, 1], on ``frames``' device. The output contract of
    ``data/flow.compute_flow``: frame 0 gets zero flow (chunk framing
    matches the RGB stream), truncation to [-FLOW_BOUND, FLOW_BOUND], scaled to
    [-1, 1]."""
    return flow_over_pairs(frames, _flow_pair_batch, pairs)

