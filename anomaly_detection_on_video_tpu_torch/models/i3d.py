"""i3res50 ("tushar-n-baseline") feature extractor in PyTorch.

Counterpart of the JAX package's ``models/i3d.py`` (``ConvBN``,
``Bottleneck``, ``I3DResNet``, ``i3res50``). Module and parameter names are
the reference's torch state-dict names (``conv1``, ``bn1``,
``layer{L}.{i}.conv{1,2,3}``, ``.bn{1,2,3}``, ``.downsample.{0,1}``), so a
reference checkpoint, or the JAX package's ``export_i3res50_state_dict``
output, loads with ``load_state_dict``.

The public layout is the JAX package's: clips ``(B, T, H, W, 3)`` in,
``(B, 2048)`` features out, in at least float32. Parameters stay float32;
``dtype`` is the compute type the input and weights are cast to.

The stem runs through kernel K2 (``ops/kernels/stem.py``) and the stage-1
blocks through kernel K3 (``ops/kernels/bottleneck.py``), both channels
last; stages 2-4 are plain torch convolutions over the channels-last
activation viewed as NCDHW. BatchNorm is always in inference mode, folded
into a float32 affine (``conv_bn``), as the reference only runs the
extractor under ``model.eval()``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.bottleneck import bottleneck_block
from ..ops.kernels.stem import fold_bn, stem_conv_pool

Stage = Tuple[int, int, int, Tuple[int, ...], Tuple[int, ...]]

# per stage: (planes, blocks, spatial stride, temporal kernel per block,
#             temporal stride per block)
I3RES50_STAGES: Tuple[Stage, ...] = (
    (64, 3, 1, (3, 3, 3), (1, 1, 1)),
    (128, 4, 2, (3, 1, 3, 1), (1, 1, 1, 1)),
    (256, 6, 2, (3, 1, 3, 1, 3, 1), (1, 1, 1, 1, 1, 1)),
    (512, 3, 2, (1, 3, 1), (1, 1, 1)),
)


def conv_bn(x: torch.Tensor, conv: nn.Conv3d, bn: nn.BatchNorm3d) -> torch.Tensor:
    """ConvBN: Conv3d (no bias) + inference BatchNorm (eps 1e-5), NCDHW,
    computed in ``x``'s dtype."""
    y = F.conv3d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)
    scale, shift = fold_bn(bn)
    view = (1, -1, 1, 1, 1)
    return y * scale.to(y.dtype).view(view) + shift.to(y.dtype).view(view)


class Bottleneck(nn.Module):
    """3D bottleneck block: conv1 k(tk,1,1) temporal, conv2 k(1,3,3)
    spatial (carries the spatial stride), conv3 1x1x1, each with BN; a
    projection shortcut (``downsample``) when the shape changes. NCDHW."""

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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(conv_bn(x, self.conv1, self.bn1))
        out = torch.relu(conv_bn(out, self.conv2, self.bn2))
        out = conv_bn(out, self.conv3, self.bn3)
        if self.downsample is not None:
            residual = conv_bn(x, self.downsample[0], self.downsample[1])
        else:
            residual = x
        return torch.relu(out + residual)


class I3DResNet(nn.Module):
    """i3res50 topology: stem Conv3d 3->64 k(5,7,7) s2 p(2,3,3) + BN + ReLU
    + MaxPool k(2,3,3) s2, bottleneck stages, temporal max pool k(2,1,1)
    after the first stage, global mean head.

    ``stages`` defaults to i3res50's; tests pass narrow ones. The stem must
    keep 64 channels (K2's width).
    """

    def __init__(self, stages: Sequence[Stage] = I3RES50_STAGES, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv3d(3, 64, (5, 7, 7), stride=(2, 2, 2), padding=(2, 3, 3), bias=False)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, T, H, W, 3)`` standardized pixels -> ``(B, C)`` features."""
        x = x.to(self.dtype)
        x = stem_conv_pool(x, self.conv1, self.bn1)  # K2, channels last
        for block in self.layer1:
            x = bottleneck_block(x, block)  # K3, channels last
        # temporal max pool k(2,1,1) s(2,1,1), VALID
        t = x.shape[1] // 2 * 2
        x = torch.maximum(x[:, 0:t:2], x[:, 1:t:2])
        x = x.permute(0, 4, 1, 2, 3)  # NCDHW view with channels-last strides
        for stage_idx in range(1, self.n_stages):
            x = getattr(self, f"layer{stage_idx + 1}")(x)
        x = x.mean(dim=(2, 3, 4))
        # features leave in >= float32 (float32 under bfloat16 compute)
        return x.to(torch.promote_types(self.dtype, torch.float32))


def i3res50(dtype: torch.dtype = torch.float32) -> I3DResNet:
    """The "tushar-n-baseline" I3Res50."""
    return I3DResNet(I3RES50_STAGES, dtype=dtype)


MODEL_ZOO = {"tushar-n-baseline": i3res50}


def build_i3d_feature_extractor(
    model_name: str = "tushar-n-baseline", dtype: torch.dtype = torch.float32
) -> I3DResNet:
    """Factory by reference model name. Weight loading is separate
    (``load_state_dict``)."""
    if model_name not in MODEL_ZOO:
        raise AttributeError(f"unknown I3D variant {model_name!r}; options: {sorted(MODEL_ZOO)}")
    return MODEL_ZOO[model_name](dtype=dtype)
