"""i3res50 ("tushar-n-baseline") feature extractor in PyTorch.

Counterpart of the JAX package's ``models/i3d.py`` (``ConvBN``,
``Bottleneck``, ``I3DResNet``, ``i3res50``). Module and parameter names are
the reference's torch state-dict names (``conv1``, ``bn1``,
``layer{L}.{i}.conv{1,2,3}``, ``.bn{1,2,3}``, ``.downsample.{0,1}``), so a
reference checkpoint, or the JAX package's ``export_i3res50_state_dict``
output, loads with ``load_state_dict``.

The public layout is the JAX package's: clips ``(B, T, H, W, C)`` in (C = 3
for RGB, ``in_channels`` = 2 for the flow stream's dx, dy),
``(B, 2048)`` features out, in at least float32. Parameters stay float32;
``dtype`` is the compute type the input and weights are cast to.

On 16x224x224 clips the stem runs through kernel K2
(``ops/kernels/stem.py``) and the stage-1 blocks through kernel K3
(``ops/kernels/bottleneck.py``), both channels last, as the JAX model takes
its fused kernels only there (``kernel_paths``); any other clip runs the
plain torch chain (``forward_unfused``). Stages 2-4 are plain torch
convolutions over the channels-last activation viewed as NCDHW. BatchNorm
is always in inference mode, folded into a float32 affine (``conv_bn``), as
the reference only runs the extractor under ``model.eval()``.

int8 execution (``act_scales``, calibrated by ``calibrate_act_scales``)
follows the JAX package's ``ConvBN._int8_conv``: every conv quantizes its
input by a static scale and its weights per output channel
(``ops/quant.py``), multiplies in int8 with int32 sums through kernel K4
(1x1x1 convs, ``ops/kernels/int8_matmul.py``) or K5 (the others,
``ops/kernels/int8_conv.py``), and dequantizes into the compute dtype
before the folded BN. As in the JAX package, the int8 model takes the
unfused chain: stem conv, BN, ReLU and max pool, then each block's own
convs; K2 and K3 are not used. Activations stay channels last throughout.
Scales are keyed by the JAX package's names (``"stem"``,
``"stage{L}_block{i}/branch_{a,b,c}"``, ``"stage{L}_block{i}/proj"``), so a
sidecar written by either package loads in the other.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels._operands import cached_operands
from ..ops.kernels.bottleneck import bottleneck_block
from ..ops.kernels.int8_conv import int8_conv, pack_int8_conv_weight
from ..ops.kernels.int8_matmul import int8_matmul
from ..ops.kernels.stem import STEM_INPUT, fold_bn, stem_conv_pool
from ..ops.quant import (
    dequant_scale,
    pack_int8_weight_nk,
    quantize_activation,
    quantize_weight,
)
from ..utils.convert import act_scale_key, block_act_scales

Stage = Tuple[int, int, int, Tuple[int, ...], Tuple[int, ...]]

# per stage: (planes, blocks, spatial stride, temporal kernel per block,
#             temporal stride per block)
I3RES50_STAGES: Tuple[Stage, ...] = (
    (64, 3, 1, (3, 3, 3), (1, 1, 1)),
    (128, 4, 2, (3, 1, 3, 1), (1, 1, 1, 1)),
    (256, 6, 2, (3, 1, 3, 1, 3, 1), (1, 1, 1, 1, 1, 1)),
    (512, 3, 2, (1, 3, 1), (1, 1, 1)),
)


AbsMax = Dict[nn.Conv3d, torch.Tensor]  # conv -> the largest |input| it has seen


def kernel_paths(stages: Sequence[Stage], clip_shape: Sequence[int]) -> Tuple[bool, bool]:
    """Whether K2 (the stem) and K3 (the stage-1 blocks) take a float
    forward of ``(T, H, W, C)`` clips: the JAX ``I3DResNet``'s
    ``use_fused_stem`` / ``use_fused_stage1`` rule. The port's model always
    has i3res50's stem geometry, no non-local block and the temporal pool
    after stage 1, so the rule reduces to the clip shape, plus spatial and
    temporal stride 1 in stage 1 for K3. Every other input runs the plain
    torch chain, as the JAX model runs it through XLA."""
    stem = tuple(clip_shape) == STEM_INPUT
    _, _, spatial_stride, _, temporal_strides = stages[0]
    return stem, stem and spatial_stride == 1 and all(ts == 1 for ts in temporal_strides)


def conv_bn(
    x: torch.Tensor,
    conv: nn.Conv3d,
    bn: nn.BatchNorm3d,
    act_scale: Optional[float] = None,
    absmax: Optional[AbsMax] = None,
) -> torch.Tensor:
    """ConvBN: Conv3d (no bias) + inference BatchNorm (eps 1e-5), NCDHW,
    computed in ``x``'s dtype; with ``act_scale``, the conv runs in int8
    (``int8_conv_nd``). ``absmax`` records the input's range in float32
    (calibration)."""
    if absmax is not None and x.numel():
        seen = x.detach().float().abs().amax()
        absmax[conv] = torch.maximum(absmax[conv], seen) if conv in absmax else seen
    if act_scale is None:
        y = F.conv3d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)
    else:
        y = int8_conv_nd(x, conv, act_scale)
    scale, shift = fold_bn(bn)
    view = (1, -1, 1, 1, 1)
    return y * scale.to(y.dtype).view(view) + shift.to(y.dtype).view(view)


def int8_conv_nd(x: torch.Tensor, conv: nn.Conv3d, act_scale: float) -> torch.Tensor:
    """The int8 conv of ``ConvBN._int8_conv`` on an NCDHW view of a
    channels-last activation: quantize the input, multiply in int8 through
    K4 (1x1x1, a strided one reads a strided slice) or K5, and dequantize
    into ``x``'s dtype. Returns an NCDHW view of a channels-last result.
    The quantized, packed weights are kept on the conv until it changes."""
    xq = quantize_activation(x.permute(0, 2, 3, 4, 1), act_scale)
    ops = cached_operands(conv, (conv.weight,), ("int8", x.device),
                          lambda: _pack_int8(conv, act_scale, x.device), settings=act_scale)
    if _is_pointwise(conv):
        st, sh, sw = conv.stride
        xq = xq[:, ::st, ::sh, ::sw].contiguous()
        y = int8_matmul(xq.reshape(-1, xq.shape[-1]), ops["w"], ops["scale"], x.dtype)
        y = y.reshape(*xq.shape[:-1], -1)
    else:
        y = int8_conv(xq.contiguous(), ops["w"], ops["scale"], conv.kernel_size, conv.stride,
                      conv.padding, x.dtype)
    return y.permute(0, 4, 1, 2, 3)


def _pack_int8(conv: nn.Conv3d, act_scale: float, device: torch.device) -> Dict[str, torch.Tensor]:
    """K4 takes a 1x1x1 conv's (N, K) weights, K5 every other conv's (its
    stem layout for the stem)."""
    w_q, w_scale = quantize_weight(conv.weight)
    pack = pack_int8_weight_nk if _is_pointwise(conv) else pack_int8_conv_weight
    return {"w": pack(w_q).to(device), "scale": dequant_scale(w_scale, act_scale).to(device)}


def _is_pointwise(conv: nn.Conv3d) -> bool:
    return tuple(conv.kernel_size) == (1, 1, 1) and tuple(conv.padding) == (0, 0, 0)


class Bottleneck(nn.Module):
    """3D bottleneck block: conv1 k(tk,1,1) temporal, conv2 k(1,3,3)
    spatial (carries the spatial stride), conv3 1x1x1, each with BN; a
    projection shortcut (``downsample``) when the shape changes. NCDHW.

    ``act_scales`` (keys ``branch_a``, ``branch_b``, ``branch_c``, ``proj``),
    set by ``I3DResNet.act_scales``, runs each conv that has a scale in int8.
    """

    def __init__(
        self,
        in_planes: int,
        planes: int,
        spatial_stride: int = 1,
        temp_kernel: int = 3,
        temp_stride: int = 1,
        has_proj: bool = False,
    ):
        super().__init__()
        self.act_scales: Optional[Dict[str, float]] = None
        self.planes = planes
        self.spatial_stride = spatial_stride
        self.temp_stride = temp_stride
        tk = temp_kernel
        self.conv1 = nn.Conv3d(in_planes, planes, (tk, 1, 1), stride=(temp_stride, 1, 1),
                               padding=(tk // 2, 0, 0), bias=False)
        self.bn1 = nn.BatchNorm3d(planes)
        self.conv2 = nn.Conv3d(planes, planes, (1, 3, 3),
                               stride=(1, spatial_stride, spatial_stride),
                               padding=(0, 1, 1), bias=False)
        self.bn2 = nn.BatchNorm3d(planes)
        self.conv3 = nn.Conv3d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm3d(planes * 4)
        self.downsample: Optional[nn.Sequential] = None
        if has_proj:
            self.downsample = nn.Sequential(
                nn.Conv3d(in_planes, planes * 4, 1,
                          stride=(temp_stride, spatial_stride, spatial_stride), bias=False),
                nn.BatchNorm3d(planes * 4),
            )

    def forward(self, x: torch.Tensor, absmax: Optional[AbsMax] = None) -> torch.Tensor:
        scales = self.act_scales or {}
        out = torch.relu(conv_bn(x, self.conv1, self.bn1, scales.get("branch_a"), absmax))
        out = torch.relu(conv_bn(out, self.conv2, self.bn2, scales.get("branch_b"), absmax))
        out = conv_bn(out, self.conv3, self.bn3, scales.get("branch_c"), absmax)
        if self.downsample is not None:
            residual = conv_bn(x, self.downsample[0], self.downsample[1], scales.get("proj"),
                               absmax)
        else:
            residual = x
        return torch.relu(out + residual)


class I3DResNet(nn.Module):
    """i3res50 topology: stem Conv3d in_channels->64 k(5,7,7) s2 p(2,3,3) +
    BN + ReLU + MaxPool k(2,3,3) s2, bottleneck stages, temporal max pool
    k(2,1,1) after the first stage, global mean head.

    ``stages`` defaults to i3res50's; tests pass narrow ones. The stem must
    keep 64 channels (K2's width). ``in_channels`` is 3 for RGB and 2 for
    the flow stream, whose clips the JAX rule sends down the plain chain
    (``kernel_paths``: K2 and K3 take 3-channel clips only; under int8, K5
    takes the stem over either). Assigning ``act_scales`` (JAX-package
    keys) makes the forward the int8 chain and gives every block its scales;
    ``None`` restores the float chain.
    """

    def __init__(
        self,
        stages: Sequence[Stage] = I3RES50_STAGES,
        dtype: torch.dtype = torch.float32,
        in_channels: int = 3,
    ):
        super().__init__()
        self.dtype = dtype
        self.stages = tuple(stages)
        self.conv1 = nn.Conv3d(in_channels, 64, (5, 7, 7), stride=(2, 2, 2), padding=(2, 3, 3), bias=False)
        self.bn1 = nn.BatchNorm3d(64)
        in_planes = 64
        self.n_stages = len(stages)
        for stage_idx, (planes, blocks, stride, tks, tss) in enumerate(stages):
            layer = []
            for block_idx in range(blocks):
                first = block_idx == 0
                has_proj = first and (stride != 1 or in_planes != planes * 4 or tss[0] != 1)
                layer.append(Bottleneck(
                    in_planes if first else planes * 4,
                    planes,
                    spatial_stride=stride if first else 1,
                    temp_kernel=tks[block_idx],
                    temp_stride=tss[block_idx] if first else 1,
                    has_proj=has_proj,
                ))
            in_planes = planes * 4
            self.add_module(f"layer{stage_idx + 1}", nn.Sequential(*layer))
        self._act_scales: Optional[Dict[str, float]] = None

    @property
    def act_scales(self) -> Optional[Dict[str, float]]:
        return self._act_scales

    @act_scales.setter
    def act_scales(self, scales: Optional[Mapping[str, float]]) -> None:
        self._act_scales = None if scales is None else dict(scales)
        for stage_idx in range(self.n_stages):
            for block_idx, block in enumerate(getattr(self, f"layer{stage_idx + 1}")):
                block.act_scales = (None if scales is None
                                    else block_act_scales(scales, stage_idx + 1, block_idx))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, H, W, in_channels)`` standardized pixels (or dequantized
        flow) -> ``(B, C)`` features."""
        x = x.to(self.dtype)
        fused_stem, fused_stage1 = kernel_paths(self.stages, x.shape[1:])
        if self._act_scales is not None or not fused_stem:
            x = self.forward_unfused(x)
        else:
            x = stem_conv_pool(x, self.conv1, self.bn1)  # K2, channels last
            first = 0
            if fused_stage1:
                for block in self.layer1:
                    x = bottleneck_block(x, block)  # K3, channels last
                x = _temporal_pool(x, 1)
                first = 1
            # NCDHW view with channels-last strides
            x = self._run_stages(x.permute(0, 4, 1, 2, 3), first)
        x = x.mean(dim=(2, 3, 4))
        # features leave in >= float32 (float32 under bfloat16 compute)
        return x.to(torch.promote_types(self.dtype, torch.float32))

    def forward_unfused(self, x: torch.Tensor, absmax: Optional[AbsMax] = None) -> torch.Tensor:
        """The chain without K2 and K3, as the JAX package runs it under
        int8 or on clips other than 16x224x224: stem ConvBN + ReLU + max
        pool, every block's own convs, the temporal pool. ``x`` channels
        last in the compute dtype; returns the last stage's output as an
        NCDHW view. A conv runs in int8 when ``act_scales`` holds its
        scale; ``absmax`` records conv inputs."""
        scales = self._act_scales or {}
        x = x.permute(0, 4, 1, 2, 3)
        x = torch.relu(conv_bn(x, self.conv1, self.bn1, scales.get("stem"), absmax))
        x = F.max_pool3d(x, (2, 3, 3), stride=(2, 2, 2))
        return self._run_stages(x, 0, absmax)

    def _run_stages(self, x: torch.Tensor, first: int, absmax: Optional[AbsMax] = None) -> torch.Tensor:
        """Stages ``first`` .. last on an NCDHW activation, with the
        temporal max pool after stage 1."""
        for stage_idx in range(first, self.n_stages):
            for block in getattr(self, f"layer{stage_idx + 1}"):
                x = block(x, absmax)
            if stage_idx == 0:
                x = _temporal_pool(x, 2)
        return x


def _temporal_pool(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Max pool k(2,1,1) s(2,1,1), VALID, over the frame axis ``dim``."""
    t = x.shape[dim] // 2 * 2
    return torch.maximum(*x.narrow(dim, 0, t).unflatten(dim, (t // 2, 2)).unbind(dim + 1))


def i3res50(dtype: torch.dtype = torch.float32, in_channels: int = 3) -> I3DResNet:
    """The "tushar-n-baseline" I3Res50 (``in_channels`` 2 for flow)."""
    return I3DResNet(I3RES50_STAGES, dtype=dtype, in_channels=in_channels)


MODEL_ZOO = {"tushar-n-baseline": i3res50}


def build_i3d_feature_extractor(
    model_name: str = "tushar-n-baseline",
    dtype: torch.dtype = torch.float32,
    in_channels: int = 3,
) -> I3DResNet:
    """Factory by reference model name, over ``in_channels`` input
    channels (3 RGB, 2 flow). Weight loading is separate
    (``load_state_dict``), and so are int8 scales (``act_scales``)."""
    if model_name not in MODEL_ZOO:
        raise AttributeError(f"unknown I3D variant {model_name!r}; options: {sorted(MODEL_ZOO)}")
    return MODEL_ZOO[model_name](dtype=dtype, in_channels=in_channels)


@torch.no_grad()
def calibrate_act_scales(model: I3DResNet, batch: torch.Tensor) -> Dict[str, float]:
    """Per-conv int8 input scales from one representative batch.

    Counterpart of the JAX package's ``calibrate_act_scales``: one forward
    of the unquantized, unfused chain in the model's dtype records every
    conv input's absmax in float32; each scale is ``max(absmax, 1e-6) /
    127``, keyed by the JAX package's conv names. Assign the result to
    ``model.act_scales``.
    """
    saved = model.act_scales
    model.act_scales = None
    absmax: AbsMax = {}
    try:
        model.forward_unfused(batch.to(model.dtype), absmax)
    finally:
        model.act_scales = saved
    names = {module: name for name, module in model.named_modules()}
    return {act_scale_key(names[conv]): max(float(value), 1e-6) / 127.0
            for conv, value in absmax.items()}
