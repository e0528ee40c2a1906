"""The stem as one 2-D conv on the card (the port's counterpart of
``scripts/stem2d_probe.py``).

i3res50's stem is a k(5,7,7) s(2,2,2) 3-D conv over 3 channels. At
temporal stride 2 it is also one 2-D conv: output frame t' sums input
frames 2t' .. 2t' + 4 of the padded clip, so the five strided frame views
stacked into channels (15 = 5 taps x 3, tap-major) make a k(7,7) s(2,2)
VALID conv over (B*8) frames of (230, 230) with the five taps' weights
stacked the same way. The same multiply-adds as the 3-D stem.

- ``stem2d_vs_3d_f32``: both in float32 on two clips with TF32 off
  (``utils.device.full_f32``): the max difference, absolute and relative
  to the peak |output|;
- ``stem3d_bf16`` at B = 120 and 240 and ``stem2d_bf16`` at B = 120 (the
  JAX probe's variants: its stem2d at B = 240 did not fit the TPU's
  memory), through cuDNN on the NCDHW view of the channels-last clips.

    python -m anomaly_detection_on_video_tpu_torch.scripts.stem2d_probe [--device cpu]
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..utils.device import full_f32
from ..utils.measure import guarded, mean_ms, probe_cli, release

CLIP = (16, 224, 224)  # (T, H, W) of a stem input clip
BATCHES = (120, 240)
PADDING = (2, 3, 3)


def stem3d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` (B, 3, T, H, W) NCDHW, ``w`` (64, 3, 5, 7, 7) -> the stem conv,
    (B, 64, T/2, H/2, W/2)."""
    return F.conv3d(x, w, None, 2, PADDING)


def stem2d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``stem3d`` as one 2-D conv over the five strided frame views stacked
    into channels (tap-major: channel ``dt * 3 + c``)."""
    b, _, t = x.shape[:3]
    xp = F.pad(x, (3, 3, 3, 3, 2, 2))  # (W, H, T) pairs, last dim first
    to = (t + 4 - 5) // 2 + 1
    stacked = torch.cat([xp[:, :, dt: dt + 2 * to: 2] for dt in range(5)], dim=1)  # (B, 15, to, ..)
    flat = stacked.transpose(1, 2).reshape(b * to, 15, *stacked.shape[3:])
    w2 = w.transpose(1, 2).reshape(w.shape[0], 15, 7, 7)  # (64, dt * 3 + c, kh, kw)
    y = F.conv2d(flat, w2, None, 2)
    return y.reshape(b, to, *y.shape[1:]).transpose(1, 2)


def probe_exactness(device: torch.device, clips: int = 2, clip: Sequence[int] = CLIP) -> dict:
    """Both formulations in float32, TF32 off, on seeded clips."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((64, 3, 5, 7, 7), generator=gen).to(device)
    x = torch.randn((clips, *clip, 3), generator=gen).to(device).permute(0, 4, 1, 2, 3)
    with full_f32():
        r3, r2 = stem3d(x, w), stem2d(x, w)
    err = float((r3 - r2).abs().max())
    return {"probe": "stem2d_vs_3d_f32", "max_abs_err": err,
            "max_rel_to_peak": round(err / float(r3.abs().max()), 10), "tf32": False}


def probe_bf16(device: torch.device, batches: Sequence[int] = BATCHES, clip: Sequence[int] = CLIP,
               reps: int = 15) -> Iterator[dict]:
    """The bf16 records: stem3d at every batch, stem2d at the first."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randn((64, 3, 5, 7, 7), generator=gen).to(device, torch.bfloat16)
    t, h, wd = clip
    for b in batches:
        def section(b=b):
            x = torch.randn((b, *clip, 3), generator=gen).to(device, torch.bfloat16)
            x = x.permute(0, 4, 1, 2, 3)  # NCDHW view, channels-last strides
            flops = 2.0 * b * (t // 2) * (h // 2) * (wd // 2) * 64 * (5 * 7 * 7 * 3)
            variants = [("stem3d_bf16", stem3d)] + ([("stem2d_bf16", stem2d)]
                                                     if b == batches[0] else [])
            records = []
            for name, fn in variants:
                ms = mean_ms(lambda: fn(x, w), reps, device)
                records.append({"probe": f"{name}_B{b}", "ms": round(ms, 4),
                                "tflops_rate": round(flops / ms / 1e9, 1)})
            return records

        yield from guarded(f"stem_bf16_B{b}", section)
        release(device)


def run(device: torch.device, batches: Sequence[int] = BATCHES, clip: Sequence[int] = CLIP,
        reps: Optional[int] = None) -> Iterator[dict]:
    """The exactness record, then the bf16 ones; ``reps`` replaces the JAX
    probe's 15 repetitions when given."""
    yield from guarded("stem2d_vs_3d_f32", lambda: probe_exactness(device, clip=clip))
    yield from probe_bf16(device, batches, clip, reps or 15)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return probe_cli(__doc__, run, argv)


if __name__ == "__main__":
    main()
