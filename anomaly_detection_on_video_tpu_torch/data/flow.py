"""The optical-flow stream's host side and its uint8 flow form.

Counterpart of the JAX package's ``data/flow.py``. ``compute_flow`` runs
cv2's Farneback between consecutive frames on the host (the ``host`` flow
backend; the device backends are ``ops/flow.py`` and ``ops/tvl1.py``), with
the I3D flow normalization: truncate to [-FLOW_BOUND, FLOW_BOUND], scale to
[-1, 1]. ``flow_to_uint8`` quantizes that to the uint8 frames the resize and
crop pipeline takes, two channels (dx, dy), and ``flow_standardize`` maps
them back to [-1, 1]; both take a numpy array or a tensor (a device flow
stays on its device). Both packages call the same cv2, so their host flows
are bit-equal. ``cv2`` is imported only inside ``compute_flow``.
"""

from __future__ import annotations

import numpy as np
import torch

FLOW_BOUND = 20.0


def compute_flow(frames: np.ndarray) -> np.ndarray:
    """Dense Farneback flow between consecutive frames: uint8 RGB
    ``(N, H, W, 3)`` -> float32 ``(N, H, W, 2)`` in [-1, 1]; frame 0 gets
    zero flow, so clip framing matches the RGB stream."""
    import cv2

    gray = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames]
    flows = [np.zeros((*gray[0].shape, 2), np.float32)]
    for prev, cur in zip(gray[:-1], gray[1:]):
        flows.append(cv2.calcOpticalFlowFarneback(
            prev, cur, None, pyr_scale=0.5, levels=3, winsize=15, iterations=3,
            poly_n=5, poly_sigma=1.2, flags=0))
    out = np.stack(flows)
    np.clip(out, -FLOW_BOUND, FLOW_BOUND, out=out)
    return out / FLOW_BOUND


def flow_to_uint8(flow):
    """[-1, 1] flow -> uint8, round((flow + 1) * 127.5), half to even; a
    tensor stays on its device."""
    if isinstance(flow, torch.Tensor):
        return torch.round((flow + 1.0) * 127.5).to(torch.uint8)
    return np.round((flow + 1.0) * 127.5).astype(np.uint8)


def flow_standardize(x):
    """The inverse of ``flow_to_uint8``: uint8 -> float32 in [-1, 1]."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32) / 127.5 - 1.0
    return x.astype(np.float32) / 127.5 - 1.0
