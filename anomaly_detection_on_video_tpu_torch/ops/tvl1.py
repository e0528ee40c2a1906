"""TV-L1 dense optical flow on the device (duality-based, Zach et al. 2007).

Counterpart of the JAX package's ``ops/tvl1.py`` (XLA, no Pallas kernel),
ported as torch ops. Per pyramid level, the second frame and its gradients
are warped to the current flow ``WARPS[level]`` times; after each warp,
``INNER_ITERATIONS`` steps alternate a pointwise thresholding of the
linearized residual (the exact L1 data-term minimizer) with a
Chambolle-style projected dual ascent on the TV term. The JAX
``lax.fori_loop`` is a Python loop here, so one pair batch launches a few
thousand small kernels on the card (15 warps x 30 steps of about 25 ops).
``[I1, I1x, I1y]`` stack into one 3-channel field, so each warp is one
gather (``ops/flow._bilinear_warp``). No per-warp median filter, as in the
JAX package (the IPOL algorithm has none).

Output contract of ``data/flow.compute_flow``: frame 0 gets zero flow,
truncation to [-FLOW_BOUND, FLOW_BOUND], scaled to [-1, 1]; float32 with TF32 off,
in sub-batches of ``ops/flow.FLOW_PAIRS`` pairs.
"""

from __future__ import annotations

import torch

from .flow import FLOW_PAIRS, _bilinear_warp, _downsample, _upsample_flow, flow_over_pairs

TAU = 0.25  # dual ascent step
LAMBDA = 0.15  # data-term weight (images in [0, 255], IPOL convention)
THETA = 0.3  # coupling between the data and TV sub-problems
LEVELS = 4  # the pyramid steps by ops/flow.PYR_SCALE
# warps per level, fine -> coarse
WARPS = (2, 3, 5, 5)
INNER_ITERATIONS = 30  # a fixed count, as the JAX package's jit needs
GRAD_EPS = 1e-8  # |grad|^2 below this is textureless (v = u)


def _forward_gradient(u: torch.Tensor):
    """``(B, H, W)`` -> forward differences (ux, uy), zero at the far edge."""
    ux = torch.cat([u[:, :, 1:] - u[:, :, :-1], torch.zeros_like(u[:, :, :1])], dim=2)
    uy = torch.cat([u[:, 1:, :] - u[:, :-1, :], torch.zeros_like(u[:, :1, :])], dim=1)
    return ux, uy


def _divergence(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Discrete divergence, the negative adjoint of ``_forward_gradient``:
    backward differences, the first row and column keeping their value."""
    d1 = torch.cat([p1[:, :, :1], p1[:, :, 1:] - p1[:, :, :-1]], dim=2)
    d2 = torch.cat([p2[:, :1, :], p2[:, 1:, :] - p2[:, :-1, :]], dim=1)
    return d1 + d2


def _central_gradient(img: torch.Tensor):
    """``(B, H, W)`` centered differences, one-sided (halved) at the borders."""
    pad_x = torch.cat([img[:, :, :1], img, img[:, :, -1:]], dim=2)
    pad_y = torch.cat([img[:, :1, :], img, img[:, -1:, :]], dim=1)
    gx = 0.5 * (pad_x[:, :, 2:] - pad_x[:, :, :-2])
    gy = 0.5 * (pad_y[:, 2:, :] - pad_y[:, :-2, :])
    return gx, gy


def _tvl1_level(i0, i1, flow, warps: int, inner: int):
    """TV-L1 at one pyramid level: ``i0``, ``i1`` ``(B, H, W)`` gray,
    ``flow`` ``(B, H, W, 2)`` (dx, dy), the initial estimate. Returns the
    refined flow."""
    l_t = LAMBDA * THETA
    taut = TAU / THETA
    g1x, g1y = _central_gradient(i1)
    field = torch.stack([i1, g1x, g1y], dim=-1)  # one gather per warp
    # the dual variables p1x p1y p2x p2y, kept as four planes
    p = [torch.zeros_like(i0) for _ in range(4)]
    u1, u2 = flow[..., 0], flow[..., 1]

    for _ in range(warps):
        warped = _bilinear_warp(field, torch.stack([u1, u2], dim=-1))
        i1w, i1wx, i1wy = warped.unbind(-1)
        grad2 = i1wx * i1wx + i1wy * i1wy
        # the residual at the warp point: rho(u) = rho_c + grad . u
        rho_c = i1w - i1wx * u1 - i1wy * u2 - i0
        textured = grad2 > GRAD_EPS
        denom = torch.clamp(grad2, min=GRAD_EPS)
        for _ in range(inner):
            rho = rho_c + i1wx * u1 + i1wy * u2
            # exact minimizer of lambda |rho(v)| + |v - u|^2 / (2 theta):
            # a step of +/- l_t along the gradient, or to the zero crossing
            step = torch.where(rho < -l_t * grad2, l_t,
                               torch.where(rho > l_t * grad2, -l_t, -rho / denom))
            step = torch.where(textured, step, 0.0)
            v1 = u1 + step * i1wx
            v2 = u2 + step * i1wy
            u1 = v1 + THETA * _divergence(p[0], p[1])
            u2 = v2 + THETA * _divergence(p[2], p[3])
            u1x, u1y = _forward_gradient(u1)
            u2x, u2y = _forward_gradient(u2)
            n1 = 1.0 + taut * torch.sqrt(u1x * u1x + u1y * u1y)
            n2 = 1.0 + taut * torch.sqrt(u2x * u2x + u2y * u2y)
            p = [(p[0] + taut * u1x) / n1, (p[1] + taut * u1y) / n1,
                 (p[2] + taut * u2x) / n2, (p[3] + taut * u2y) / n2]
    return torch.stack([u1, u2], dim=-1)


def _flow_pair_batch_tvl1(prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor:
    """Dense TV-L1 flow for gray pairs ``(B, H, W)`` -> ``(B, H, W, 2)`` px."""
    pyr_prev, pyr_cur = [prev], [cur]
    for _ in range(LEVELS - 1):
        pyr_prev.append(_downsample(pyr_prev[-1]))
        pyr_cur.append(_downsample(pyr_cur[-1]))

    flow = torch.zeros((*pyr_prev[-1].shape, 2), dtype=torch.float32, device=prev.device)
    for level in reversed(range(LEVELS)):
        p, c = pyr_prev[level], pyr_cur[level]
        if flow.shape[1:3] != p.shape[1:3]:
            flow = _upsample_flow(flow, *p.shape[1:3])
        flow = _tvl1_level(p, c, flow, WARPS[level], INNER_ITERATIONS)
    return flow


def compute_flow_tvl1(frames: torch.Tensor, pairs: int = FLOW_PAIRS) -> torch.Tensor:
    """uint8 RGB ``(N, H, W, 3)`` -> float32 TV-L1 flow ``(N, H, W, 2)`` in
    [-1, 1], on ``frames``' device, with ``compute_flow_device``'s output
    contract. Gray stays in [0, 255]: LAMBDA follows the IPOL convention
    for that range."""
    return flow_over_pairs(frames, _flow_pair_batch_tvl1, pairs)
