"""The I3D (3D-ResNet50) feature extractors in PyTorch: i3res50
("tushar-n-baseline", with or without non-local blocks) and
``i3d_8x8_r50``, either with the space-to-depth stem.

Counterpart of the JAX package's ``models/i3d.py`` (``ConvBN``,
``S2DConv`` / ``S2DConvBN``, ``NonLocalBlock``, ``Bottleneck``,
``I3DResNet``, ``i3res50``, ``i3d_8x8_r50``). One ``I3DResNet`` takes the
JAX model's geometry fields (stem conv and pool, stages, the temporal pool
after a stage, the head pool, non-local stages, the S2D stem). Module and
parameter names are the reference's torch state-dict names for every
variant (``conv1``, ``bn1``, ``layer{L}.{i}.conv{1,2,3}``, ``.bn{1,2,3}``,
``.downsample.{0,1}``, ``.nl.{theta,phi,g,out,bn}``), so a reference
checkpoint, or the JAX package's ``export_i3res50_state_dict`` output,
loads with ``load_state_dict``; ``utils/convert.py`` maps the pytorchvideo
layout of ``i3d_8x8_r50`` onto the same names.

The public layout is the JAX package's: clips ``(B, T, H, W, C)`` in (C = 3
for RGB, ``in_channels`` = 2 for the flow stream's dx, dy),
``(B, 2048)`` features out, in at least float32. Parameters stay float32;
``dtype`` is the compute type the input and weights are cast to.

Where the JAX model takes its fused kernels (``kernel_paths``: i3res50's
stem geometry without the S2D stem, on 16x224x224 clips), the stem runs
through kernel K2 (``ops/kernels/stem.py``) and the stage-1 blocks, when
they have no non-local block, stride 1 and the temporal pool after them,
through kernel K3 (``ops/kernels/bottleneck.py``), both channels last; any
other model or clip runs the plain torch chain (``forward_unfused``).
Stages 2-4 are plain torch convolutions over the channels-last activation
viewed as NCDHW. BatchNorm is always in inference mode, folded into an
affine of at least float32 (``conv_bn``), as the reference only runs the
extractor under ``model.eval()``.

int8 execution (``act_scales``, calibrated by ``calibrate_act_scales``)
follows the JAX package's ``ConvBN._int8_conv``: every conv quantizes its
input by a static scale and its weights per output channel
(``ops/quant.py``), multiplies in int8 with int32 sums through kernel K4
(1x1x1 convs, ``ops/kernels/int8_matmul.py``) or K5 (the others,
``ops/kernels/int8_conv.py``; the stem at stride (2,2,2) or (1,2,2)), and
dequantizes into the compute dtype before the folded BN. As in the JAX
package, the int8 model takes the unfused chain: stem conv, BN, ReLU and
max pool, then each block's own convs; K2 and K3 are not used. The
non-local blocks' convs and the S2D stem are not ``ConvBN`` in the JAX
package: they stay in the compute dtype and have no scale. Activations
stay channels last throughout. Scales are keyed by the JAX package's names
(``"stem"``, ``"stage{L}_block{i}/branch_{a,b,c}"``,
``"stage{L}_block{i}/proj"``), so a sidecar written by either package loads
in the other.
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
Triple = Tuple[int, int, int]
# (stem kernel, stem stride, stem pool kernel, stem pool stride, stem pool padding)
StemGeometry = Tuple[Triple, Triple, Triple, Triple, Triple]

# per stage: (planes, blocks, spatial stride, temporal kernel per block,
#             temporal stride per block); both variants share them
I3RES50_STAGES: Tuple[Stage, ...] = (
    (64, 3, 1, (3, 3, 3), (1, 1, 1)),
    (128, 4, 2, (3, 1, 3, 1), (1, 1, 1, 1)),
    (256, 6, 2, (3, 1, 3, 1, 3, 1), (1, 1, 1, 1, 1, 1)),
    (512, 3, 2, (1, 3, 1), (1, 1, 1)),
)
I3RES50_STEM: StemGeometry = ((5, 7, 7), (2, 2, 2), (2, 3, 3), (2, 2, 2), (0, 0, 0))
I3D_8X8_STEM: StemGeometry = ((5, 7, 7), (1, 2, 2), (1, 3, 3), (1, 2, 2), (0, 1, 1))


AbsMax = Dict[nn.Conv3d, torch.Tensor]  # conv -> the largest |input| it has seen


def kernel_paths(
    stages: Sequence[Stage],
    clip_shape: Sequence[int],
    stem: StemGeometry = I3RES50_STEM,
    s2d_stem: bool = False,
    nonlocal_stages: Sequence[int] = (),
    pool_after_stage: Optional[int] = 0,
) -> Tuple[bool, bool]:
    """Whether K2 (the stem) and K3 (the stage-1 blocks) take a float
    forward of ``(T, H, W, C)`` clips: the JAX ``I3DResNet``'s
    ``use_fused_stem`` / ``use_fused_stage1`` rule. K2 needs i3res50's stem
    geometry without the S2D stem, on 16x224x224 RGB clips; K3 needs the
    same, plus spatial and temporal stride 1 in stage 1, no non-local block
    there and the temporal pool right after it. Every other model or clip
    runs the plain torch chain, as the JAX model runs it through XLA."""
    fused_stem = (not s2d_stem and tuple(map(tuple, stem)) == I3RES50_STEM
                  and tuple(clip_shape) == STEM_INPUT)
    _, _, spatial_stride, _, temporal_strides = stages[0]
    return fused_stem, (fused_stem and spatial_stride == 1
                        and all(ts == 1 for ts in temporal_strides)
                        and 0 not in nonlocal_stages and pool_after_stage == 0)


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
    return _affine(y, bn)


def _affine(y: torch.Tensor, bn: nn.BatchNorm3d) -> torch.Tensor:
    """Inference BN on NCDHW ``y``, folded in at least float32 and applied
    in ``y``'s dtype."""
    scale, shift = fold_bn(bn, torch.promote_types(y.dtype, torch.float32))
    view = (1, -1, 1, 1, 1)
    return y * scale.to(y.dtype).view(view) + shift.to(y.dtype).view(view)


def s2d_conv3d(x: torch.Tensor, weight: torch.Tensor, stride: Triple, padding: Triple) -> torch.Tensor:
    """The JAX package's ``S2DConv``: the strided conv of ``weight`` over
    the NCDHW view ``x`` as a stride-1 conv over space-to-depth blocks.
    Each (s_t, s_h, s_w) block of the padded input becomes channels
    ordered (c, r_t, r_h, r_w); the kernel's taps are zero-padded to
    multiples of the stride and regrouped by phase the same way. The same
    linear map as ``F.conv3d(x, weight, None, stride, padding)``, computed
    in ``x``'s dtype; returns an NCDHW view of a channels-last result.
    Raises ValueError when a padded dim does not divide by its stride."""
    b = x.shape[0]
    xc = F.pad(x.permute(0, 2, 3, 4, 1),
               (0, 0, padding[2], padding[2], padding[1], padding[1], padding[0], padding[0]))
    spatial = tuple(xc.shape[1:4])
    for size, s in zip(spatial, stride):
        if size % s:
            raise ValueError(f"S2DConv needs padded input dims divisible by the stride; got "
                             f"{spatial} with strides {tuple(stride)} — use the plain stem "
                             f"(s2d_stem=False) for this shape")
    ft, fh, fw = stride
    c = xc.shape[-1]
    xs = xc.reshape(b, spatial[0] // ft, ft, spatial[1] // fh, fh, spatial[2] // fw, fw, c)
    xs = xs.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(
        b, spatial[0] // ft, spatial[1] // fh, spatial[2] // fw, c * ft * fh * fw)
    k = weight.to(x.dtype).permute(2, 3, 4, 1, 0)  # (kt, kh, kw, I, O), flax's layout
    taps = [-(-kk // f) * f for kk, f in zip(k.shape[:3], stride)]
    k = F.pad(k, (0, 0, 0, 0, 0, taps[2] - k.shape[2], 0, taps[1] - k.shape[1],
                  0, taps[0] - k.shape[0]))
    jt, jh, jw = (t // f for t, f in zip(taps, stride))
    o = k.shape[-1]
    k = k.reshape(jt, ft, jh, fh, jw, fw, c, o).permute(0, 2, 4, 6, 1, 3, 5, 7)
    k = k.reshape(jt, jh, jw, c * ft * fh * fw, o).permute(4, 3, 0, 1, 2)
    return F.conv3d(xs.permute(0, 4, 1, 2, 3), k)


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


class NonLocalBlock(nn.Module):
    """Embedded-Gaussian non-local block, the JAX package's
    ``NonLocalBlock``: ``theta`` from x, ``phi`` and ``g`` from x max-pooled
    over k(1,2,2) s(1,2,2), 1x1x1 convs with bias; softmax attention over
    the flattened (T, H, W) positions, its logits scaled by ``dim_inner **
    -0.5`` and the logits and softmax in at least float32; an output conv,
    BN and the residual. NCDHW views of channels-last activations; its
    convs run in the compute dtype (never int8), as the JAX block's plain
    ``nn.Conv``."""

    def __init__(self, dim: int, dim_inner: int):
        super().__init__()
        self.dim_inner = dim_inner
        self.theta = nn.Conv3d(dim, dim_inner, 1)
        self.phi = nn.Conv3d(dim, dim_inner, 1)
        self.g = nn.Conv3d(dim, dim_inner, 1)
        self.out = nn.Conv3d(dim_inner, dim, 1)
        self.bn = nn.BatchNorm3d(dim)

    @staticmethod
    def _conv(x: torch.Tensor, conv: nn.Conv3d) -> torch.Tensor:
        return F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        pooled = F.max_pool3d(x, (1, 2, 2), stride=(1, 2, 2))
        theta = self._conv(x, self.theta)
        t_shape = theta.permute(0, 2, 3, 4, 1).shape

        def rows(y: torch.Tensor) -> torch.Tensor:  # (B, C, T, H, W) -> (B, THW, C)
            return y.permute(0, 2, 3, 4, 1).reshape(b, -1, self.dim_inner)

        acc = torch.promote_types(x.dtype, torch.float32)  # float32 logits under bf16
        logits = torch.matmul(rows(theta).to(acc),
                              rows(self._conv(pooled, self.phi)).to(acc).transpose(1, 2))
        attn = torch.softmax(logits * self.dim_inner ** -0.5, dim=-1).to(x.dtype)
        out = torch.matmul(attn, rows(self._conv(pooled, self.g)))
        out = self._conv(out.reshape(t_shape).permute(0, 4, 1, 2, 3), self.out)
        return _affine(out, self.bn) + x


class Bottleneck(nn.Module):
    """3D bottleneck block: conv1 k(tk,1,1) temporal, conv2 k(1,3,3)
    spatial (carries the spatial stride), conv3 1x1x1, each with BN; a
    projection shortcut (``downsample``) when the shape changes. NCDHW.

    ``act_scales`` (keys ``branch_a``, ``branch_b``, ``branch_c``, ``proj``),
    set by ``I3DResNet.act_scales``, runs each conv that has a scale in int8.
    ``use_nl`` appends a ``NonLocalBlock`` (``nl``, inner width 2 x planes)
    after the block's final ReLU.
    """

    def __init__(
        self,
        in_planes: int,
        planes: int,
        spatial_stride: int = 1,
        temp_kernel: int = 3,
        temp_stride: int = 1,
        has_proj: bool = False,
        use_nl: bool = False,
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
        self.nl = NonLocalBlock(planes * 4, planes * 2) if use_nl else None

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
        out = torch.relu(out + residual)
        return out if self.nl is None else self.nl(out)


class I3DResNet(nn.Module):
    """The JAX ``I3DResNet``: stem Conv3d ``in_channels`` -> 64
    k``stem_kernel`` s``stem_stride`` (padding kernel // 2) + BN + ReLU +
    MaxPool k``stem_pool_kernel`` s``stem_pool_stride``
    p``stem_pool_padding``, bottleneck ``stages``, a temporal max pool
    k(2,1,1) after stage index ``pool_after_stage``, non-local blocks after
    the odd blocks of ``nonlocal_stages``, an optional AvgPool
    ``head_pool_kernel`` (stride 1, VALID) and the global mean. The
    defaults are i3res50's; ``i3d_8x8_r50`` changes the stem and the head.

    ``s2d_stem`` runs the stem conv as the space-to-depth conv
    (``s2d_conv3d``, the same parameters and linear map); like the JAX
    ``S2DConvBN`` it is never quantized nor calibrated. The stem must keep
    64 channels (K2's width). ``in_channels`` is 3 for RGB and 2 for the
    flow stream, whose clips the JAX rule sends down the plain chain
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
        stem_kernel: Triple = (5, 7, 7),
        stem_stride: Triple = (2, 2, 2),
        stem_pool_kernel: Triple = (2, 3, 3),
        stem_pool_stride: Triple = (2, 2, 2),
        stem_pool_padding: Triple = (0, 0, 0),
        pool_after_stage: Optional[int] = 0,
        head_pool_kernel: Optional[Triple] = None,
        nonlocal_stages: Sequence[int] = (),
        s2d_stem: bool = False,
    ):
        super().__init__()
        self.dtype = dtype
        self.stages = tuple(stages)
        self.stem = tuple(tuple(v) for v in (stem_kernel, stem_stride, stem_pool_kernel,
                                             stem_pool_stride, stem_pool_padding))
        self.pool_after_stage = pool_after_stage
        self.head_pool_kernel = None if head_pool_kernel is None else tuple(head_pool_kernel)
        self.nonlocal_stages = tuple(nonlocal_stages)
        self.s2d_stem = s2d_stem
        self.conv1 = nn.Conv3d(in_channels, 64, stem_kernel, stride=stem_stride,
                               padding=tuple(k // 2 for k in stem_kernel), bias=False)
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
                    use_nl=stage_idx in self.nonlocal_stages and block_idx % 2 == 1,
                ))
            in_planes = planes * 4
            self.add_module(f"layer{stage_idx + 1}", nn.Sequential(*layer))
        self._act_scales: Optional[Dict[str, float]] = None

    def kernel_paths(self, clip_shape: Sequence[int]) -> Tuple[bool, bool]:
        """(K2, K3) for a float forward of ``clip_shape`` clips: the
        module-level ``kernel_paths`` of this model's geometry."""
        return kernel_paths(self.stages, clip_shape, self.stem, self.s2d_stem,
                            self.nonlocal_stages, self.pool_after_stage)

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
        fused_stem, fused_stage1 = self.kernel_paths(x.shape[1:])
        if self._act_scales is not None or not fused_stem:
            return self.head(self.forward_unfused(x))
        x = stem_conv_pool(x, self.conv1, self.bn1)  # K2, channels last
        first = 0
        if fused_stage1:
            for block in self.layer1:
                x = bottleneck_block(x, block)  # K3, channels last
            x = _temporal_pool(x, 1)
            first = 1
        # NCDHW view with channels-last strides
        return self.head(self._run_stages(x.permute(0, 4, 1, 2, 3), first))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The last stage's NCDHW output -> ``(B, C)`` features in at least
        float32: the head pool (if any), then the global mean."""
        if self.head_pool_kernel is not None:
            x = F.avg_pool3d(x, self.head_pool_kernel, stride=1)
        # features leave in >= float32 (float32 under bfloat16 compute)
        return x.mean(dim=(2, 3, 4)).to(torch.promote_types(self.dtype, torch.float32))

    def forward_unfused(self, x: torch.Tensor, absmax: Optional[AbsMax] = None) -> torch.Tensor:
        """The chain without K2 and K3, as the JAX package runs it under
        int8 or for clips and models the kernels do not take: stem ConvBN
        (or the S2D stem) + ReLU + max pool, every block's own convs, the
        temporal pool. ``x`` channels last in the compute dtype; returns
        the last stage's output as an NCDHW view (``head`` makes the
        features). A conv runs in int8 when ``act_scales`` holds its
        scale; ``absmax`` records conv inputs."""
        scales = self._act_scales or {}
        x = x.permute(0, 4, 1, 2, 3)
        if self.s2d_stem:  # never quantized nor calibrated, as the JAX S2DConvBN
            x = _affine(s2d_conv3d(x, self.conv1.weight, self.conv1.stride,
                                   self.conv1.padding), self.bn1)
        else:
            x = conv_bn(x, self.conv1, self.bn1, scales.get("stem"), absmax)
        _, _, pool_kernel, pool_stride, pool_padding = self.stem
        x = F.max_pool3d(torch.relu(x), pool_kernel, stride=pool_stride, padding=pool_padding)
        return self._run_stages(x, 0, absmax)

    def _run_stages(self, x: torch.Tensor, first: int, absmax: Optional[AbsMax] = None) -> torch.Tensor:
        """Stages ``first`` .. last on an NCDHW activation, with the
        temporal max pool after stage ``pool_after_stage``."""
        for stage_idx in range(first, self.n_stages):
            for block in getattr(self, f"layer{stage_idx + 1}"):
                x = block(x, absmax)
            if stage_idx == self.pool_after_stage:
                x = _temporal_pool(x, 2)
        return x


def _temporal_pool(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Max pool k(2,1,1) s(2,1,1), VALID, over the frame axis ``dim``."""
    t = x.shape[dim] // 2 * 2
    return torch.maximum(*x.narrow(dim, 0, t).unflatten(dim, (t // 2, 2)).unbind(dim + 1))


def i3res50(dtype: torch.dtype = torch.float32, in_channels: int = 3, use_nl: bool = False,
            s2d_stem: bool = False) -> I3DResNet:
    """The "tushar-n-baseline" I3Res50 (``in_channels`` 2 for flow);
    ``use_nl`` adds non-local blocks to stages 2 and 3 (the JAX
    ``nonlocal_stages=(1, 2)``)."""
    return I3DResNet(I3RES50_STAGES, dtype, in_channels, *I3RES50_STEM,
                     nonlocal_stages=(1, 2) if use_nl else (), s2d_stem=s2d_stem)


def i3d_8x8_r50(dtype: torch.dtype = torch.float32, s2d_stem: bool = False,
                in_channels: int = 3) -> I3DResNet:
    """The pytorchvideo-style i3d_8x8_r50 (the JAX ``i3d_8x8_r50``): stem
    conv k(5,7,7) s(1,2,2), stem MaxPool k(1,3,3) s(1,2,2) p(0,1,1), the
    temporal pool after stage 1, head AvgPool(4,7,7) then the global mean.
    Its clips keep 16 frames through the stem, so stage 1 runs at T = 16."""
    return I3DResNet(I3RES50_STAGES, dtype, in_channels, *I3D_8X8_STEM,
                     head_pool_kernel=(4, 7, 7), s2d_stem=s2d_stem)


MODEL_ZOO = {"tushar-n-baseline": i3res50, "i3d_8x8_r50": i3d_8x8_r50}


def build_i3d_feature_extractor(
    model_name: str = "tushar-n-baseline",
    dtype: torch.dtype = torch.float32,
    in_channels: int = 3,
    **model_kwargs,
) -> I3DResNet:
    """Factory by reference model name, over ``in_channels`` input
    channels (3 RGB, 2 flow); ``model_kwargs`` pass to the variant's
    factory (``s2d_stem=True``; ``use_nl=True`` for i3res50). Weight
    loading is separate (``load_state_dict``), and so are int8 scales
    (``act_scales``)."""
    if model_name not in MODEL_ZOO:
        raise AttributeError(f"unknown I3D variant {model_name!r}; options: {sorted(MODEL_ZOO)}")
    return MODEL_ZOO[model_name](dtype=dtype, in_channels=in_channels, **model_kwargs)


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
