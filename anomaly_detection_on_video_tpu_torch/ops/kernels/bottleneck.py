"""K3: one i3res50 stage-1 bottleneck block in one launch.

Replaces ``bottleneck_block`` (anomaly_detection_on_video_tpu/ops/pallas/
bottleneck.py:176) with its ``pack_block_params`` (:53): conv_a k(3,1,1)
(a k(1,1,1) conv zero-padded to three taps) + BN + ReLU, conv_b k(1,3,3)
+ BN + ReLU, conv_c 1x1x1 + BN, the optional 1x1x1 projection + BN, residual
add, ReLU. ``(B, T, 55, 55, Cin)`` -> ``(B, T, 55, 55, 256)`` channels last,
planes 64, Cin 64 (block 0, with projection) or 256.

On the H100 the block sits near the memory roofline at large batch: the
256-channel activations it reads and writes outweigh its operations. The
CUDA kernel (``csrc/bottleneck.cu``) keeps both 64-channel intermediates in
shared memory, as the TPU kernel keeps them in VMEM, so each block costs one
read of its input and one write of its output. BN arrives folded to float32
affines. In bfloat16 the four products run on the tensor cores and the
weights arrive as bf16 (out, in) matrices, K contiguous per output channel;
in float32 they stay on CUDA cores (tensor cores would round float32 to
TF32) with float32 (in, out) matrices.
"""

from __future__ import annotations

from typing import Dict

import torch

from ._operands import cached_operands
from .stem import fold_bn

PLANE = 55
PLANES = 64


def pack_block_params(block, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A ``models.i3d.Bottleneck`` -> the kernel's operands for ``dtype``.

    float32, (in, out) matrices: wa (3, Cin, P), wb (9*P, P) with rows
    (kh, kw, in), wc (P, 4P), wp (Cin, 4P). bfloat16, (out, in) matrices
    with K contiguous, as the tensor-core fragments read them: wa (3, P,
    Cin), wb (P, 9*P) with columns (kh, kw, in), wc (4P, P), wp (4P, Cin).
    Weights hold the values of ``dtype``; the folded BN affines are float32.
    """
    def weight(conv):
        return conv.weight.detach().to(dtype).float()

    wa = weight(block.conv1)[:, :, :, 0, 0].permute(2, 1, 0)  # (tk, Cin, P)
    if wa.shape[0] == 1:  # temporal kernel 1 == kernel 3 with zero outer taps
        wa = torch.nn.functional.pad(wa, (0, 0, 0, 0, 1, 1))
    planes = wa.shape[-1]
    ops = {
        "wa": wa,
        "wb": weight(block.conv2)[:, :, 0].permute(2, 3, 1, 0).reshape(9 * planes, planes),
        "wc": weight(block.conv3)[:, :, 0, 0, 0].t(),
    }
    if block.downsample is not None:
        ops["wp"] = weight(block.downsample[0])[:, :, 0, 0, 0].t()
    if dtype == torch.bfloat16:
        ops = {k: v.transpose(-1, -2).to(dtype) for k, v in ops.items()}
    ops["sa"], ops["ba"] = fold_bn(block.bn1)
    ops["sb"], ops["bb"] = fold_bn(block.bn2)
    ops["sc"], ops["bc"] = fold_bn(block.bn3)
    if block.downsample is not None:
        ops["sp"], ops["bp"] = fold_bn(block.downsample[1])
    return {k: v.contiguous() for k, v in ops.items()}


def bottleneck_plain(x: torch.Tensor, block) -> torch.Tensor:
    """Plain version: the ``Bottleneck`` module's own ops, channels last."""
    return block(x.permute(0, 4, 1, 2, 3)).permute(0, 2, 3, 4, 1).contiguous()


def bottleneck_block(x: torch.Tensor, block) -> torch.Tensor:
    """``(B, T, H, W, Cin)`` -> ``(B, T, H, W, 4P)`` through ``block``.

    A CPU tensor takes the plain version (any width). A CUDA tensor launches
    the kernel, which takes stride-1 blocks with 64 planes on a contiguous
    55x55 float32 or bfloat16 plane, in bfloat16 with Cin = 64 and a
    projection or Cin = 256 without, and raises on anything else. The
    kernel's operands are packed at the first launch and kept until the
    block's weights change (``_operands.cached_operands``).
    """
    if x.dim() != 5:
        raise ValueError(f"expected (B, T, H, W, C) activations, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"bottleneck takes float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return bottleneck_plain(x, block)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, t, h, w, cin = x.shape
    if (h, w) != (PLANE, PLANE) or block.planes != PLANES or cin % 16:
        raise ValueError(
            f"the bottleneck kernel takes (B, T, 55, 55, Cin) with 64 planes, got "
            f"{tuple(x.shape)} and {block.planes} planes")
    if block.spatial_stride != 1 or block.temp_stride != 1:
        raise ValueError("the bottleneck kernel takes stride-1 blocks only")
    has_proj = block.downsample is not None
    if not has_proj and cin != 4 * PLANES:
        raise ValueError(f"an identity shortcut needs Cin = {4 * PLANES}, got {cin}")
    if has_proj and x.dtype == torch.bfloat16 and cin != PLANES:
        raise ValueError(f"the bfloat16 kernel takes a projection from Cin = {PLANES}, got {cin}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("bottleneck input must be contiguous and 16-byte aligned")
    from ._build import build, current_stream

    lib = build()
    ops = cached_operands(
        block, (*block.parameters(), *block.buffers()), (x.dtype, x.device),
        lambda: {k: v.to(x.device) for k, v in pack_block_params(block, x.dtype).items()})
    out = torch.empty((b, t, h, w, 4 * PLANES), dtype=x.dtype, device=x.device)
    null = 0  # the projection operands of a block without one
    lib.call(
        "adv_bottleneck", x.data_ptr(), out.data_ptr(),
        *(ops[k].data_ptr() if k in ops else null
          for k in ("wa", "wb", "wc", "wp", "sa", "ba", "sb", "bb", "sc", "bc", "sp", "bp")),
        int(x.dtype == torch.bfloat16), b, t, cin, int(has_proj),
        current_stream(x),
    )
    bottleneck_block.launches += 1
    return out


bottleneck_block.launches = 0
