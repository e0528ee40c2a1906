"""Where the I3D forward's time goes on the card, stage by stage (the
port's counterpart of ``scripts/stage_probe.py``).

Sections, each printing JSON lines under the JAX probe's names and keys,
each guarded (a section that raises prints ``{"probe": ..., "error":
...}`` and the others still run):

  1. stages 1-4 of i3res50 alone (``StageOnly``: the port's ``Bottleneck``
     modules at the JAX probe's specs), bf16 at B = 240 through cuDNN, on
     the NCDHW view of a channels-last activation as the model holds it:
     ms, TFLOP, GB, MFU against the H100's dense bf16 peak and the HBM
     rate. FLOPs and bytes are counted from the shapes (``stage_cost``),
     where the JAX probe read XLA's cost analysis. Stage 1 here is the three
     generic modules at the input K3 takes, a yardstick beside K3, not
     K3's work in one call;
  2. ``FeatureExtractor`` in bf16 at batch 240 and 480, two groups each,
     frames already on the card (K1, K2 and K3 launch once, once and three
     times a group; each record carries the launches of one pass);
  3. the int8 microprobes: an 8192 x 2048 x 2048 product in bf16 (cuBLAS)
     and in int8 (``torch._int_mm``, with K4 on the same operands beside
     it), and a k(3,3) conv at a stage-2 shape in bf16 (cuDNN) and in
     int8 through K5 (torch has no int8 conv on CUDA).

    python -m anomaly_detection_on_video_tpu_torch.scripts.stage_probe [--device cpu]
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..data.extraction import FeatureExtractor
from ..models import seeded_init_
from ..models.i3d import AbsMax, Bottleneck
from ..ops.kernels import int8_conv, int8_matmul, launch_counts
from ..ops.kernels.int8_conv import conv_output_shape
from ..utils.convert import BRANCH_OF_CONV
from ..utils.measure import PEAK_FLOPS, guarded, mean_ms, probe_cli, release
from .int8_pallas_probe import int_mm_ms

B = 240
# stage -> (planes, blocks, spatial stride, temporal kernel per block, the
# stage's input (C, T, H, W) per clip in the forward): the JAX probe's specs
STAGE_SPECS: Dict[int, Tuple[int, int, int, Tuple[int, ...], Tuple[int, int, int, int]]] = {
    1: (64, 3, 1, (3, 3, 3), (64, 4, 55, 55)),
    2: (128, 4, 2, (3, 1, 3, 1), (256, 2, 55, 55)),
    3: (256, 6, 2, (3, 1, 3, 1, 3, 1), (512, 2, 28, 28)),
    4: (512, 3, 2, (1, 3, 1), (1024, 2, 14, 14)),
}
PIPELINE_BATCHES = (240, 480)
MATMUL_MKN = (8192, 2048, 2048)
FRAME_SHAPE = (240, 320, 3)
KERNELS_K1_K3 = ("ten_crop_standardize", "stem_conv_pool", "bottleneck_block")


class StageOnly(nn.Sequential):
    """One i3res50 stage alone, the JAX probe's ``StageOnly``: ``blocks``
    bottlenecks of ``planes``, the first with the spatial stride and the
    projection. NCDHW in and out. ``act_scales`` takes the JAX stage's
    int8 keys (``block{i}/branch_a`` ... ``block{i}/proj``) and hands each
    block its own; ``calibrate`` makes them."""

    def __init__(self, in_planes: int, planes: int, blocks: int, stride: int,
                 temp_kernels: Sequence[int]):
        super().__init__(*(Bottleneck(in_planes if i == 0 else planes * 4, planes,
                                      spatial_stride=stride if i == 0 else 1,
                                      temp_kernel=temp_kernels[i], has_proj=i == 0)
                           for i in range(blocks)))

    @classmethod
    def from_spec(cls, spec) -> "StageOnly":
        planes, blocks, stride, tks, shape = spec
        return cls(shape[0], planes, blocks, stride, tks)

    def forward(self, x: torch.Tensor, absmax: Optional[AbsMax] = None) -> torch.Tensor:
        for block in self:
            x = block(x, absmax)
        return x

    @property
    def act_scales(self) -> Optional[Dict[str, float]]:
        if self[0].act_scales is None:
            return None
        return {f"block{i}/{k}": v for i, block in enumerate(self)
                for k, v in block.act_scales.items()}

    @act_scales.setter
    def act_scales(self, scales: Optional[Mapping[str, float]]) -> None:
        for i, block in enumerate(self):
            block.act_scales = None if scales is None else {
                k.split("/", 1)[1]: v for k, v in scales.items() if k.startswith(f"block{i}/")}

    @torch.no_grad()
    def calibrate(self, x: torch.Tensor) -> Dict[str, float]:
        """Per-conv int8 input scales from one unquantized forward of ``x``,
        as ``models.i3d.calibrate_act_scales`` makes a model's: ``max(absmax,
        1e-6) / 127`` of each conv's input, under the JAX stage's keys.
        Leaves the stage unquantized."""
        saved = self.act_scales
        self.act_scales = None
        absmax: AbsMax = {}
        try:
            self(x, absmax)
        finally:
            self.act_scales = saved
        names = {module: name for name, module in self.named_modules()}
        scales = {}
        for conv, value in absmax.items():
            block, conv_name = names[conv].split(".", 1)
            scales[f"block{block}/{BRANCH_OF_CONV[conv_name]}"] = max(float(value), 1e-6) / 127.0
        return scales


def stage_convs(stage: StageOnly, in_shape: Sequence[int]):
    """(conv, input (C, T, H, W), output (C, T, H, W)) per clip for every
    conv of ``stage`` on ``in_shape`` inputs, in the forward's order."""
    def out(conv: nn.Conv3d, shape) -> Tuple[int, ...]:
        return (conv.out_channels, *conv_output_shape(shape[1:], conv.kernel_size, conv.stride,
                                                      conv.padding))

    shape = tuple(in_shape)
    for block in stage:
        a = out(block.conv1, shape)
        b = out(block.conv2, a)
        c = out(block.conv3, b)
        yield from ((block.conv1, shape, a), (block.conv2, a, b), (block.conv3, b, c))
        if block.downsample is not None:
            yield block.downsample[0], shape, out(block.downsample[0], shape)
        shape = c


def stage_cost(stage: StageOnly, in_shape: Sequence[int], batch: int,
               dtype: torch.dtype = torch.bfloat16) -> Tuple[float, float]:
    """(FLOPs, bytes) of a forward of ``batch`` clips: 2 x the convs'
    multiply-adds (the BN, ReLU and residual elementwise work not counted),
    and the bytes each input is read and each output written once: the
    activation in and out in ``dtype``, the parameters and BN statistics as
    stored (float32)."""
    flops, out_shape = 0.0, tuple(in_shape)
    for conv, (cin, *_), out_shape in stage_convs(stage, in_shape):  # the last is the output's
        flops += 2.0 * batch * math.prod(out_shape) * cin * math.prod(conv.kernel_size)
    itemsize = torch.empty((), dtype=dtype).element_size()
    weights = sum(t.numel() * t.element_size() for t in stage.state_dict().values()
                  if t.is_floating_point())
    return flops, batch * (math.prod(in_shape) + math.prod(out_shape)) * itemsize + weights


def int8_launches(stage: StageOnly) -> Dict[str, int]:
    """The int8 stage's kernel launches by the model's rule: K4 for every
    1x1x1 conv (``conv3``, the projection, a temporal kernel of 1), K5 for
    the rest."""
    kernels = [tuple(m.kernel_size) for m in stage.modules() if isinstance(m, nn.Conv3d)]
    pointwise = kernels.count((1, 1, 1))
    return {"int8_matmul": pointwise, "int8_conv": len(kernels) - pointwise}


def stage_input(spec, batch: int, device: torch.device, dtype: torch.dtype,
                seed: int = 0) -> torch.Tensor:
    """A seeded (batch, C, T, H, W) activation: the NCDHW view of a
    channels-last tensor, as the model holds its activations."""
    c, t, h, w = spec[4]
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((batch, t, h, w, c), generator=gen).to(device, dtype)
    return x.permute(0, 4, 1, 2, 3)


def build_stage(spec, device: torch.device, seed: int = 0) -> StageOnly:
    """``StageOnly`` of ``spec`` with seeded weights, in eval mode."""
    return seeded_init_(StageOnly.from_spec(spec), seed).to(device).eval()


def probe_stage(stage_idx: int, device: torch.device, batch: int = B, reps: int = 20,
                specs=STAGE_SPECS) -> dict:
    """Section 1's record of one stage in bf16."""
    spec = specs[stage_idx]
    stage = build_stage(spec, device)
    x = stage_input(spec, batch, device, torch.bfloat16)
    with torch.no_grad():
        ms = mean_ms(lambda: stage(x), reps, device)
    flops, nbytes = stage_cost(stage, spec[4], batch)
    seconds = ms / 1e3
    return {"probe": f"stage{stage_idx}", "ms": round(ms, 4), "tflop": round(flops / 1e12, 4),
            "gb": round(nbytes / 1e9, 4),
            "mfu": round(flops / seconds / PEAK_FLOPS["bfloat16"], 5),
            "hbm_gbps": round(nbytes / seconds / 1e9, 2),
            "input": [batch, *spec[4]], "convs": "F.conv3d bf16 (cuDNN on the card)"}


def probe_pipeline(batch: int, device: torch.device, rng: np.random.RandomState,
                   reps: int = 10) -> dict:
    """Section 2's record: ``FeatureExtractor(batch=batch)`` in bf16 over
    two groups of clips whose uint8 frames are on the device already;
    ``launches`` are K1-K3's in one untimed pass."""
    n_clips = (batch // 10) * 2  # two groups
    frames = rng.randint(0, 256, (n_clips * 16, *FRAME_SHAPE), np.uint8)
    ex = FeatureExtractor(dtype=torch.bfloat16, batch=batch, device=device)
    on_device = torch.from_numpy(frames).to(device)
    before = launch_counts()
    ex.extract_frames(on_device)
    after = launch_counts()
    ms = mean_ms(lambda: ex.extract_frames(on_device), reps, device, warmup=0)
    return {"probe": f"pipeline_batch{batch}", "ms_per_chunk": round(ms, 3),
            "clips_per_sec": round(n_clips / ms * 1e3, 2),
            "launches": {k: after[k] - before[k] for k in KERNELS_K1_K3}}


def probe_matmuls(device: torch.device, mkn: Sequence[int] = MATMUL_MKN,
                  reps: int = 50) -> List[dict]:
    """Section 3's products: bf16 by cuBLAS; int8 by ``torch._int_mm`` (the
    library's, where XLA ran the JAX probe's), with K4 on the same operands
    beside it."""
    m, k, n = mkn
    gen = torch.Generator().manual_seed(0)
    a8 = torch.randint(-127, 127, (m, k), generator=gen, dtype=torch.int8).to(device)
    w8 = torch.randint(-127, 127, (n, k), generator=gen, dtype=torch.int8).to(device)  # (N, K)
    abf, wbf = a8.to(torch.bfloat16), w8.t().to(torch.bfloat16)
    flops = 2.0 * m * k * n

    def timer(fn, iters):
        return mean_ms(fn, iters, device)

    bf16_ms = timer(lambda: abf @ wbf, reps)
    lib_ms = int_mm_ms(a8, w8, reps, timer)
    k4_ms = timer(lambda: int8_matmul(a8, w8), reps)
    return [{"probe": "matmul_bf16", "us": round(bf16_ms * 1e3, 2),
             "tflops_rate": round(flops / bf16_ms / 1e9, 1), "library": "torch.matmul (cuBLAS)"},
            {"probe": "matmul_int8", "us": None if lib_ms is None else round(lib_ms * 1e3, 2),
             "tflops_rate": None if lib_ms is None else round(flops / lib_ms / 1e9, 1),
             "library": "torch._int_mm" if lib_ms is not None else "torch._int_mm refused",
             "k4_us": round(k4_ms * 1e3, 2), "k4_tflops_rate": round(flops / k4_ms / 1e9, 1)}]


def probe_convs(device: torch.device, batch: int = B, reps: int = 30) -> List[dict]:
    """Section 3's k(3,3) conv, 512 -> 128 channels at (2 * batch, 28, 28):
    bf16 ``F.conv2d`` (cuDNN on the card) on the NCHW view of channels-last
    planes, and int8 through K5 as the k(1,3,3) conv over (2 * batch, 1,
    28, 28, 512), its float32 epilogue at scale 1 (four bytes out, like the
    JAX probe's int32)."""
    gen = torch.Generator().manual_seed(0)
    x8 = torch.randint(-127, 127, (2 * batch, 28, 28, 512), generator=gen,
                       dtype=torch.int8).to(device)
    w8 = torch.randint(-127, 127, (128, 3, 3, 512), generator=gen,
                       dtype=torch.int8).to(device)  # (Cout, kh, kw, Cin)
    xbf = x8.to(torch.bfloat16).permute(0, 3, 1, 2)
    wbf = w8.to(torch.bfloat16).permute(0, 3, 1, 2)
    x5, w5 = x8[:, None], w8.reshape(128, -1)  # K5's (B, 1, H, W, C) and (Cout, K)
    ones = torch.ones(128, dtype=torch.float32, device=device)
    flops = 2.0 * x8.shape[0] * 28 * 28 * 512 * 128 * 9
    bf16_ms = mean_ms(lambda: F.conv2d(xbf, wbf, None, 1, 1), reps, device)
    int8_ms = mean_ms(lambda: int8_conv(x5, w5, ones, (1, 3, 3), (1, 1, 1), (0, 1, 1),
                                        torch.float32), reps, device)
    return [{"probe": "conv_bf16", "ms": round(bf16_ms, 4),
             "tflops_rate": round(flops / bf16_ms / 1e9, 1), "library": "F.conv2d (cuDNN)"},
            {"probe": "conv_int8", "ms": round(int8_ms, 4),
             "tflops_rate": round(flops / int8_ms / 1e9, 1),
             "kernel": "K5 int8_conv: no library call (torch has no int8 conv on CUDA)"}]


def run(device: torch.device, batch: int = B, specs=STAGE_SPECS,
        pipeline_batches: Sequence[int] = PIPELINE_BATCHES, mkn: Sequence[int] = MATMUL_MKN,
        reps: Optional[int] = None) -> Iterator[dict]:
    """The three sections' records; ``reps`` replaces each section's own
    repetitions (20, 10, 50 and 30, the JAX probe's) when given."""
    for stage_idx in specs:
        yield from guarded(f"stage{stage_idx}",
                           lambda: probe_stage(stage_idx, device, batch, reps or 20, specs))
        release(device)
    rng = np.random.RandomState(0)
    for pb in pipeline_batches:
        yield from guarded(f"pipeline_batch{pb}",
                           lambda: probe_pipeline(pb, device, rng, reps or 10))
        release(device)
    yield from guarded("matmul", lambda: probe_matmuls(device, mkn, reps or 50))
    yield from guarded("conv", lambda: probe_convs(device, batch, reps or 30))


def main(argv: Optional[List[str]] = None) -> List[dict]:
    return probe_cli(__doc__, run, argv)


if __name__ == "__main__":
    main()
