"""A/B on the card: each I3D conv as a 3-D conv and as the same math as a
2-D conv (the port's counterpart of ``scripts/conv2d_probe.py``).

Every I3D conv is k(kt,1,1), k(1,kh,kw) or 1x1x1, so each maps to a 2-D
conv by a free reshape of the channels-last activation: the spatial
k(1,3,3) over (B*T, H, W) frames, the temporal k(3,1,1) over (B, T, H*W)
planes. The probe times both formulations of k(1,3,3) at the stage 1-3
shapes and of k(3,1,1) at the stage-2 shape, B = 240, reshapes inside the
timed call, under the JAX probe's names and keys:

- bf16 through cuDNN (``F.conv3d`` / ``F.conv2d`` on NCDHW / NCHW views of
  the channels-last tensor);
- int8 through K5 both ways (torch has no int8 conv on CUDA): the 3-D
  conv, and K5 on the reshaped (B*T, 1, H, W, C) or (B, T, H*W, 1, C)
  tensor, each with its bf16 dequantize epilogue.

Each 2-D record also holds its output against the 3-D one: the least row
cosine in bf16, the count of unequal elements in int8 (integer sums agree
in any order, so 0).

    python -m anomaly_detection_on_video_tpu_torch.scripts.conv2d_probe [--device cpu]
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional

import torch
import torch.nn.functional as F

from ..ops.kernels import int8_conv, pack_int8_conv_weight
from ..utils.measure import guarded, mean_ms, probe_cli, release
from .stage_probe import B

# kind -> K5's (kernel, padding); stride 1
GEOMETRY = {"spatial": ((1, 3, 3), (0, 1, 1)), "temporal": ((3, 1, 1), (1, 0, 0))}
# tag -> (kind, input (C, T, H, W) per clip, Cout): the JAX probe's cases, in its order
CASES = {
    "s1_spatial": ("spatial", (64, 4, 55, 55), 64),
    "s2_spatial": ("spatial", (128, 2, 28, 28), 128),
    "s3_spatial": ("spatial", (256, 2, 14, 14), 256),
    "s2_temporal": ("temporal", (512, 2, 28, 28), 128),
}


def conv_3d(kind: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Channels-last ``x`` (B, T, H, W, C), ``w`` (Cout, Cin, kt, kh, kw)
    -> (B, T, H, W, Cout) by one 3-D conv."""
    _, pad = GEOMETRY[kind]
    return F.conv3d(x.permute(0, 4, 1, 2, 3), w, None, 1, pad).permute(0, 2, 3, 4, 1)


def conv_2d(kind: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The same map by one 2-D conv: over (B*T) frames of (H, W) for the
    spatial kernel, over B planes of (T, H*W) for the temporal one."""
    b, t, h, wd, c = x.shape
    if kind == "spatial":
        y = F.conv2d(x.reshape(b * t, h, wd, c).permute(0, 3, 1, 2), w[:, :, 0], None, 1, 1)
    else:
        y = F.conv2d(x.reshape(b, t, h * wd, c).permute(0, 3, 1, 2), w[..., 0], None, 1, (1, 0))
    return y.permute(0, 2, 3, 1).reshape(b, t, h, wd, -1)


def int8_3d(kind: str, x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K5 on int8 channels-last ``x`` with packed ``wp`` (Cout, K)."""
    kernel, pad = GEOMETRY[kind]
    return int8_conv(x, wp, scale, kernel, (1, 1, 1), pad, out_dtype)


def int8_2d(kind: str, x: torch.Tensor, wp: torch.Tensor, scale: torch.Tensor,
            out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """K5 on the 2-D formulation's reshape: (B*T, 1, H, W, C) for the
    spatial kernel, (B, T, H*W, 1, C) for the temporal one."""
    kernel, pad = GEOMETRY[kind]
    b, t, h, wd, c = x.shape
    flat = x.reshape(b * t, 1, h, wd, c) if kind == "spatial" else x.reshape(b, t, h * wd, 1, c)
    return int8_conv(flat, wp, scale, kernel, (1, 1, 1), pad, out_dtype).reshape(b, t, h, wd, -1)


def min_row_cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.reshape(a.shape[0], -1).double(), b.reshape(b.shape[0], -1).double()
    return float(F.cosine_similarity(a, b, dim=1).min())


def probe_case(tag: str, dt: str, device: torch.device, batch: int = B, reps: int = 30,
               cases=CASES) -> List[dict]:
    """The 3-D and 2-D records of one case in one type."""
    kind, (c, t, h, w), cout = cases[tag]
    kernel, _ = GEOMETRY[kind]
    gen = torch.Generator().manual_seed(0)
    if dt == "bf16":
        x = torch.randn((batch, t, h, w, c), generator=gen).to(device, torch.bfloat16)
        wt = torch.randn((cout, c, *kernel), generator=gen).to(device, torch.bfloat16)
        fns = {"3d": lambda: conv_3d(kind, x, wt), "2d": lambda: conv_2d(kind, x, wt)}
    else:
        x = torch.randint(-127, 127, (batch, t, h, w, c), generator=gen, dtype=torch.int8)
        wq = torch.randint(-127, 127, (cout, c, *kernel), generator=gen, dtype=torch.int8)
        x, wp = x.to(device), pack_int8_conv_weight(wq).to(device)
        scale = torch.full((cout,), 1e-6, dtype=torch.float32, device=device)
        fns = {"3d": lambda: int8_3d(kind, x, wp, scale), "2d": lambda: int8_2d(kind, x, wp, scale)}
    flops = 2.0 * batch * t * h * w * c * cout * math.prod(kernel)
    records, outs = [], {}
    for form, fn in fns.items():
        ms = mean_ms(fn, reps, device)
        outs[form] = fn()
        records.append({"probe": f"{tag}_{form}_{dt}", "ms": round(ms, 4),
                        "tflops_rate": round(flops / ms / 1e9, 1)})
    if dt == "bf16":
        records[1]["cosine_vs_3d"] = round(min_row_cosine(outs["2d"], outs["3d"]), 8)
    else:
        records[1]["unequal_vs_3d"] = int((outs["2d"] != outs["3d"]).sum())
        records[1]["kernel"] = records[0]["kernel"] = (
            "K5 int8_conv: no library call (torch has no int8 conv on CUDA)")
    return records


def run(device: torch.device, batch: int = B, cases=CASES,
        reps: Optional[int] = None) -> Iterator[dict]:
    """Every case's records, each case and type guarded; ``reps`` replaces
    the JAX probe's 30 repetitions when given."""
    for tag in cases:
        for dt in ("bf16", "int8"):
            yield from guarded(f"{tag}_{dt}", lambda: probe_case(tag, dt, device, batch,
                                                                 reps or 30, cases))
            release(device)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return probe_cli(__doc__, run, argv)


if __name__ == "__main__":
    main()
