"""int8 against bf16 by conv geometry and by stage on the card (the port's
counterpart of ``scripts/int8_stage_probe.py``).

Two parts, under the JAX probe's names and keys, each record guarded:

- the 3-D conv microprobes at the stage-2 k(1,3,3) and k(3,1,1) shapes
  and the stem's k(5,7,7) at stride 2, B = 240: bf16 through cuDNN
  (``F.conv3d`` on the NCDHW view of a channels-last activation), int8
  through K5 with its bf16 dequantize epilogue (torch has no int8 conv on
  CUDA);
- stages 1 and 2 in int8 (``stage_probe.StageOnly`` at the JAX specs,
  B = 240): scales calibrated on the input first (``StageOnly.calibrate``,
  the model's ``conv_bn`` absmax path), then every conv quantized through
  K4 (1x1x1) or K5 (the rest) with the quantize, BN and ReLU passes around
  them. Each stage record carries its K4 and K5 launches in one pass
  beside the launches its specs imply, and the device time of one profiled
  pass split into K4, K5 and the elementwise work around them
  (``utils/profiling.trace``; on the card only).

    python -m anomaly_detection_on_video_tpu_torch.scripts.int8_stage_probe [--device cpu]
"""

from __future__ import annotations

import contextlib
import math
import tempfile
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.nn.functional as F

from ..models import i3d
from ..ops.kernels import (int8_conv, int8_conv_plain, int8_matmul_plain, launch_counts,
                           pack_int8_conv_weight)
from ..ops.kernels.int8_conv import conv_output_shape
from ..utils.measure import guarded, mean_ms, probe_cli, release
from ..utils.profiling import device_kernel_ms, trace
from .stage_probe import B, STAGE_SPECS, build_stage, int8_launches, stage_input

# name -> (input (C, T, H, W) per clip, weight (Cout, Cin, kt, kh, kw)): the JAX shapes
CONV_SHAPES = {
    "stage2_spatial_k133": ((128, 2, 28, 28), (128, 128, 1, 3, 3)),
    "stage2_temporal_k311": ((512, 2, 28, 28), (128, 512, 3, 1, 1)),
    "stem_k577": ((3, 16, 224, 224), (64, 3, 5, 7, 7)),
}
INT8_STAGES = (1, 2)
K4_K5 = ("int8_matmul", "int8_conv")


def probe_conv3d(name: str, dt: str, device: torch.device, batch: int = B, reps: int = 20,
                 shapes=CONV_SHAPES) -> dict:
    """One conv microprobe: bf16 by cuDNN, or int8 by K5 (bf16 out)."""
    (c, t, h, w), ws = shapes[name]
    kernel = ws[2:]
    stride = (2, 2, 2) if name.startswith("stem") else (1, 1, 1)
    pad = tuple(k // 2 for k in kernel)
    gen = torch.Generator().manual_seed(0)
    if dt == "bf16":
        x = torch.randn((batch, t, h, w, c), generator=gen).to(device, torch.bfloat16)
        x = x.permute(0, 4, 1, 2, 3)  # NCDHW view, channels-last strides
        wt = torch.randn(ws, generator=gen).to(device, torch.bfloat16)
        fn, route = (lambda: F.conv3d(x, wt, None, stride, pad)), {"library": "F.conv3d (cuDNN)"}
    else:
        x = torch.randint(-127, 127, (batch, t, h, w, c), generator=gen, dtype=torch.int8)
        wq = torch.randint(-127, 127, ws, generator=gen, dtype=torch.int8)
        x, wp = x.to(device), pack_int8_conv_weight(wq).to(device)
        scale = torch.full((ws[0],), 1e-4, dtype=torch.float32, device=device)
        fn = lambda: int8_conv(x, wp, scale, kernel, stride, pad, torch.bfloat16)  # noqa: E731
        route = {"kernel": "K5 int8_conv: no library call (torch has no int8 conv on CUDA)"}
    ms = mean_ms(fn, reps, device)
    out_elems = batch * math.prod(conv_output_shape((t, h, w), kernel, stride, pad))
    flops = 2.0 * out_elems * math.prod(ws[1:]) * ws[0]
    return {"probe": f"conv3d_{name}_{dt}", "ms": round(ms, 4),
            "tflops_rate": round(flops / ms / 1e9, 1), **route}


@contextlib.contextmanager
def plain_int8_kernels() -> Iterator[None]:
    """The int8 convs of ``models/i3d.py`` through K4's and K5's plain
    versions inside the block (the reference an int8 stage is held to)."""
    saved = i3d.int8_matmul, i3d.int8_conv
    i3d.int8_matmul, i3d.int8_conv = int8_matmul_plain, int8_conv_plain
    try:
        yield
    finally:
        i3d.int8_matmul, i3d.int8_conv = saved


def device_split(kernel_ms: Dict[str, float]) -> Dict[str, float]:
    """A profiled pass's device ms as K4, K5, and the elementwise work (every
    other kernel: quantize, BN, ReLU, the residual add; copies apart)."""
    split = {"k4_ms": 0.0, "k5_ms": 0.0, "elementwise_ms": 0.0, "copies_ms": 0.0}
    for name, ms in kernel_ms.items():
        key = ("k4_ms" if "int8_matmul_kernel" in name else "k5_ms" if "int8_conv_kernel" in name
               else "copies_ms" if "emcpy" in name or "emset" in name else "elementwise_ms")
        split[key] += ms
    return {k: round(v, 4) for k, v in split.items()}


def probe_stage_int8(stage_idx: int, device: torch.device, batch: int = B, reps: int = 20,
                     specs=STAGE_SPECS, check_plain: bool = False) -> dict:
    """One stage in int8: calibrate, then time. ``check_plain`` also runs
    the stage through the plain versions and counts the elements that
    differ (0: bit-equal)."""
    spec = specs[stage_idx]
    stage = build_stage(spec, device)
    x = stage_input(spec, batch, device, torch.bfloat16)
    record = {"probe": f"stage{stage_idx}_int8"}
    with torch.no_grad():
        stage.act_scales = stage.calibrate(x)
        before = launch_counts()
        out = stage(x)
        after = launch_counts()
        record["ms"] = round(mean_ms(lambda: stage(x), reps, device), 4)
        record["launches"] = {k: after[k] - before[k] for k in K4_K5}
        record["expected_launches"] = int8_launches(stage)
        if device.type == "cuda":
            with tempfile.TemporaryDirectory() as logdir:
                with trace(logdir) as prof:
                    stage(x)
            record["profiled_pass"] = device_split(device_kernel_ms(prof))
        if check_plain:
            with plain_int8_kernels():
                ref = stage(x)
            record["unequal_vs_plain"] = int((out != ref).sum())
    return record


def run(device: torch.device, batch: int = B, conv_shapes=CONV_SHAPES,
        stages: Sequence[int] = INT8_STAGES, specs=STAGE_SPECS, reps: Optional[int] = None,
        check_plain: bool = False) -> Iterator[dict]:
    """The microprobes' records, then the int8 stages'; ``reps`` replaces
    the JAX probe's 20 repetitions when given."""
    for name in conv_shapes:
        for dt in ("bf16", "int8"):
            yield from guarded(f"conv3d_{name}_{dt}", lambda: probe_conv3d(
                name, dt, device, batch, reps or 20, conv_shapes))
            release(device)
    for stage_idx in stages:
        yield from guarded(f"stage{stage_idx}_int8", lambda: probe_stage_int8(
            stage_idx, device, batch, reps or 20, specs, check_plain))
        release(device)


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return probe_cli(__doc__, run, argv)


if __name__ == "__main__":
    main()
