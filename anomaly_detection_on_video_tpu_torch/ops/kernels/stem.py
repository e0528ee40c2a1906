"""K2: the i3res50 stem - conv + folded BN + ReLU + max pool in one kernel.

Replaces ``stem_conv_pool_h`` (anomaly_detection_on_video_tpu/ops/pallas/
stem.py:150) and its XLA tail ``stem_pool_w`` (:188): Conv3d 3->64
k(5,7,7) s(2,2,2) p(2,3,3), BN folded to a float32 affine as
``pack_stem_params`` (:58) folds it, ReLU, MaxPool3d k(2,3,3) s(2,2,2).
``(B, 16, 224, 224, 3)`` -> ``(B, 4, 55, 55, 64)``, channels last.

On the H100 it is bound by operations: about 9.4 GFLOP of conv per clip
against 0.6 MB of pixels, 0.34 ms at B = 40 on the bf16 tensor cores. The
CUDA kernel (``csrc/stem.cu``) computes the stem positions a tile of pooled
outputs needs and pools them in its epilogue, so the (B, 8, 112, 112, 64)
stem activation never reaches device memory. In bfloat16 it runs on the
tensor cores (``mma.sync`` m16n8k16 fed by ``ldmatrix``): the contraction
runs over the 5 temporal taps x 3 channels of each (kh, kw) tap, padded to
one k16 step, against a slab of per-pixel vectors staged once per CTA, and
the weights are the (64, 784) matrix of ``pack_stem_params``. float32
stays on CUDA-core FMAs, since tensor cores would round it to TF32.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ._operands import cached_operands

STEM_INPUT = (16, 224, 224, 3)  # the only clip geometry the kernel takes
STEM_OUTPUT = (4, 55, 55, 64)
STEM_TAP_K = 16  # the bf16 operand's K per (kh, kw) tap: 5 x 3 values, padded


def fold_bn(bn: nn.modules.batchnorm._BatchNorm,
            dtype: torch.dtype = torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BN as an affine in ``dtype`` (float32, as
    ``pack_stem_params`` folds it; float64 for a float64 forward):
    ``scale = gamma * rsqrt(var + eps)``, ``shift = beta - mean * scale``."""
    scale = bn.weight.detach().to(dtype) * torch.rsqrt(bn.running_var.to(dtype) + bn.eps)
    return scale, bn.bias.detach().to(dtype) - bn.running_mean.to(dtype) * scale


def pack_stem_params(conv_weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch (64, 3, 5, 7, 7) conv weight -> the kernel's operand for ``dtype``.

    float32: (735, 64), rows ordered (kt, kh, kw, c), for the CUDA-core
    kernel. bfloat16: the tensor-core operand, (64, 784) bfloat16, each
    output channel's row K-contiguous: 49 taps (kh, kw), each the 16 values
    ``[kt * 3 + c]`` of one k16 step, the 16th zero.
    """
    w = conv_weight.detach()
    if dtype == torch.float32:
        return w.float().permute(2, 3, 4, 1, 0).reshape(-1, w.shape[0]).contiguous()
    taps = w.to(dtype).permute(0, 3, 4, 2, 1).reshape(w.shape[0], 7 * 7, 5 * 3)
    return F.pad(taps, (0, STEM_TAP_K - 5 * 3)).reshape(w.shape[0], -1).contiguous()


def stem_plain(
    x: torch.Tensor, conv_weight: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor
) -> torch.Tensor:
    """Plain version: conv3d, folded BN, ReLU, max_pool3d (channels last)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), conv_weight.to(x.dtype), None,
                 stride=(2, 2, 2), padding=(2, 3, 3))
    view = (1, -1, 1, 1, 1)
    y = torch.relu(y * scale.to(y.dtype).view(view) + shift.to(y.dtype).view(view))
    y = F.max_pool3d(y, (2, 3, 3), stride=(2, 2, 2))
    return y.permute(0, 2, 3, 4, 1).contiguous()


def stem_conv_pool(x: torch.Tensor, conv: nn.Conv3d, bn: nn.BatchNorm3d) -> torch.Tensor:
    """``(B, T, H, W, 3)`` pixels -> pooled stem ``(B, T/4, H', W', 64)``
    through the stem ``conv`` and its ``bn``.

    A CPU tensor takes the plain version (any clip size). A CUDA tensor
    launches the kernel, which takes only (B, 16, 224, 224, 3) contiguous
    float32 or bfloat16 clips and raises on anything else. The kernel's
    operands are packed at the first launch and kept until the weights
    change (``_operands.cached_operands``).
    """
    if x.dim() != 5 or x.shape[-1] != 3:
        raise ValueError(f"expected (B, T, H, W, 3) clips, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stem takes float32 or bfloat16, got {x.dtype}")
    if tuple(conv.weight.shape) != (64, 3, 5, 7, 7):
        raise ValueError(f"expected a (64, 3, 5, 7, 7) stem conv, got {tuple(conv.weight.shape)}")
    if x.device.type == "cpu":
        return stem_plain(x, conv.weight, *fold_bn(bn))
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if tuple(x.shape[1:]) != STEM_INPUT:
        raise ValueError(f"the stem kernel takes (B, 16, 224, 224, 3) clips, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("stem input must be contiguous and 16-byte aligned")
    if x.shape[0] * 4 > 65535:
        raise ValueError(f"batch {x.shape[0]} exceeds the launch grid")
    from ._build import build, current_stream

    lib = build()

    def pack():
        scale, shift = fold_bn(bn)
        ops = {"w": pack_stem_params(conv.weight, x.dtype), "scale": scale, "shift": shift}
        return {k: v.to(x.device).contiguous() for k, v in ops.items()}

    sources = (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
    ops = cached_operands(conv, sources, (x.dtype, x.device), pack)
    out = torch.empty((x.shape[0], *STEM_OUTPUT), dtype=x.dtype, device=x.device)
    lib.call(
        "adv_stem", x.data_ptr(), ops["w"].data_ptr(), ops["scale"].data_ptr(),
        ops["shift"].data_ptr(), out.data_ptr(), int(x.dtype == torch.bfloat16), x.shape[0],
        current_stream(x),
    )
    stem_conv_pool.launches += 1
    return out


stem_conv_pool.launches = 0


def stem_kernel_info() -> dict:
    """The bf16 kernel's launch shape on the current card: shared bytes per
    CTA, threads, CTAs resident per SM, pooled rows x columns per tile."""
    import ctypes

    from ._build import build

    info = (ctypes.c_int * 5)()
    build().call("adv_stem_info", info)
    keys = ("shared_bytes", "threads", "ctas_per_sm", "tile_rows", "tile_cols")
    return dict(zip(keys, info))
