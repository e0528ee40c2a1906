"""K5: int8 3D convolution, channels last, with a per-channel scale epilogue.

Replaces ``make_conv3x3`` / ``_conv3x3_kernel``
(scripts/int8_pallas_probe.py:159 / :116): an int8 3x3 conv with zero
padding, int32 accumulation, and a per-output-channel float32 scale whose
product is either requantized to int8 (``clip(round(.), -127, 127)``, round
half to even) or written as bfloat16. Generalized to the i3res50 int8
path's geometries (k(1,3,3) with stride 1 or 2, k(3,1,1), the stem's
k(5,7,7) s2 p(2,3,3) over 3 channels) and to a float32 output.

The CUDA kernel (``csrc/int8_conv.cu``) is an implicit GEMM on the tensor
cores (``mma.sync`` s8.s8.s32) that gathers its A tiles from the
activation, so no im2col copy reaches device memory. The plain version is
``F.conv3d`` in float64 on the int8 values, exact for the path's sums.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..quant import check_epilogue, scale_epilogue
from .int8_matmul import MODES

Triple = Tuple[int, int, int]


def _triple(v: Sequence[int], name: str) -> Triple:
    v = tuple(int(i) for i in v)
    if len(v) != 3:
        raise ValueError(f"{name} must have three entries, got {v}")
    return v


def conv_output_shape(shape, kernel: Triple, stride: Triple, padding: Triple) -> Triple:
    """(To, Ho, Wo) of a conv over (T, H, W)."""
    return tuple((n + 2 * p - k) // s + 1 for n, k, s, p in zip(shape, kernel, stride, padding))


def int8_conv_plain(x, w_packed, scale, kernel, stride, padding, out_dtype) -> torch.Tensor:
    """Plain version, on any device: ``F.conv3d`` in float64 on the int8
    values, cast to int32, then the same epilogue in torch ops."""
    kernel, stride, padding = (_triple(v, n) for v, n in
                               ((kernel, "kernel"), (stride, "stride"), (padding, "padding")))
    # rows (kt, kh, kw, cin) x cout -> torch (cout, cin, kt, kh, kw)
    w = w_packed.reshape(*kernel, x.shape[-1], -1).permute(4, 3, 0, 1, 2).double()
    acc = F.conv3d(x.permute(0, 4, 1, 2, 3).double(), w, None, stride, padding)
    return scale_epilogue(acc.permute(0, 2, 3, 4, 1).to(torch.int32), scale, out_dtype)


def int8_conv(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    kernel: Sequence[int],
    stride: Sequence[int],
    padding: Sequence[int],
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """``x`` int8 ``(B, T, H, W, Cin)`` -> ``(B, To, Ho, Wo, Cout)`` as
    ``out_dtype`` (int8, float32 or bfloat16): the zero-padded conv with
    ``w_packed`` int8 ``(kt*kh*kw*Cin, Cout)``, its int32 sum times the
    float32 ``(Cout,)`` ``scale``. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel, and anything it does not take raises.
    """
    kernel, stride, padding = (_triple(v, n) for v, n in
                               ((kernel, "kernel"), (stride, "stride"), (padding, "padding")))
    if scale is None:
        raise ValueError("int8_conv needs a per-channel scale")
    if x.dtype != torch.int8 or w_packed.dtype != torch.int8:
        raise ValueError(f"int8_conv takes int8 operands, got {x.dtype} and {w_packed.dtype}")
    if x.dim() != 5 or w_packed.dim() != 2:
        raise ValueError(f"expected (B, T, H, W, Cin) and (K, Cout), got {tuple(x.shape)} "
                         f"and {tuple(w_packed.shape)}")
    b, t, h, w, cin = x.shape
    if w_packed.shape[0] != kernel[0] * kernel[1] * kernel[2] * cin:
        raise ValueError(f"weights {tuple(w_packed.shape)} do not match kernel {kernel} "
                         f"over {cin} channels")
    if min(stride) < 1 or min(padding) < 0 or min(kernel) < 1:
        raise ValueError(f"bad geometry: kernel {kernel}, stride {stride}, padding {padding}")
    out_shape = conv_output_shape((t, h, w), kernel, stride, padding)
    if min(out_shape) < 1:
        raise ValueError(f"kernel {kernel} does not fit the padded input {tuple(x.shape)}")
    cout = w_packed.shape[1]
    check_epilogue(scale, cout, out_dtype, (torch.int8, torch.float32, torch.bfloat16), x.device)
    if w_packed.device != x.device:
        raise ValueError(f"operands on {x.device} and {w_packed.device}")
    if x.device.type == "cpu":
        return int8_conv_plain(x, w_packed, scale, kernel, stride, padding, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("int8_conv operands must be contiguous")
    m = b * out_shape[0] * out_shape[1] * out_shape[2]
    if x.numel() >= 2 ** 31 or m * cout >= 2 ** 31:
        raise ValueError(f"{tuple(x.shape)} exceeds the kernel's 32-bit sizes")
    from ._build import build, current_stream

    lib = build()
    out = x.new_empty((b, *out_shape, cout), dtype=out_dtype)
    lib.call(
        "adv_int8_conv", x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        b, t, h, w, cin, cout, *kernel, *stride, *padding, MODES[out_dtype],
        current_stream(x),
    )
    int8_conv.launches += 1
    return out


int8_conv.launches = 0
