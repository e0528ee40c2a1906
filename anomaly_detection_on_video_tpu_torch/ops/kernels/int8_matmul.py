"""K4: int8 x int8 -> int32 matrix product with an optional scale epilogue.

Replaces ``probe_raw_matmul`` (scripts/int8_pallas_probe.py:75), whose
body is ``dot_general(w (K, N), x (K, M))`` contracting dim 0 into int32:
in channels-last order, ``a (M, K) . w (N, K)^T``, the weights packed once
with K contiguous (``ops.quant.pack_int8_weight_nk``), the operand layout
Hopper's int8 ``wgmma`` reads. With a per-column float32
``scale`` the result is ``float32(acc) * scale[n]`` rounded once into
float32 or bfloat16, the dequantize of the JAX package's
``ConvBN._int8_conv``. Every 1x1x1 int8 conv of the i3res50 int8 path is
this product over its channels-last activation.

PyTorch on CUDA has no integer matrix product that the port may use, so
the CUDA kernel (``csrc/int8_matmul.cu``) is the path: 128 x 256 (or
128 x 128) tiles fed by TMA through a ring of shared-memory stages, int32
sums on the tensor cores through ``wgmma`` s32.s8.s8, and the scale in the
epilogue. TMA needs 16-byte strides, so K and N must be multiples of 16
and both operands 16-byte aligned. The plain version computes in float64, which
is exact while every |sum| stays below 2^53 (the path's largest K is 6144,
so sums stay below 6144 * 127^2 < 2^27).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quant import check_epilogue, scale_epilogue

MODES = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2, torch.int8: 3}


def int8_matmul_plain(
    a: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain version, on any device: the exact product in float64, cast to
    int32, then the same epilogue in torch ops."""
    acc = (a.double() @ w.double().t()).to(torch.int32)
    return acc if scale is None else scale_epilogue(acc, scale, out_dtype)


def int8_matmul(
    a: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``a`` int8 ``(M, K)`` times the transpose of ``w`` int8 ``(N, K)``.

    Without ``scale``: the int32 ``(M, N)`` sum. With a float32 ``(N,)``
    ``scale``: ``float32(sum) * scale`` as ``out_dtype`` (float32 or
    bfloat16). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel, and anything the kernel does not take raises.
    """
    if a.dtype != torch.int8 or w.dtype != torch.int8:
        raise ValueError(f"int8_matmul takes int8 operands, got {a.dtype} and {w.dtype}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[1]:
        raise ValueError(f"expected (M, K) and (N, K), got {tuple(a.shape)} and {tuple(w.shape)}")
    if scale is None:
        if out_dtype not in (None, torch.int32):
            raise ValueError("out_dtype needs a scale; without one the result is int32")
        out_dtype = torch.int32
    else:
        check_epilogue(scale, w.shape[0], out_dtype, (torch.float32, torch.bfloat16), a.device)
    if w.device != a.device:
        raise ValueError(f"operands on {a.device} and {w.device}")
    if a.device.type == "cpu":
        return int8_matmul_plain(a, w, scale, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("int8_matmul operands must be contiguous")
    m, k = a.shape
    n = w.shape[0]
    if k % 16 or n % 16 or a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"the kernel's TMA loads need K and N multiples of 16 and 16-byte "
                         f"aligned operands, got K = {k}, N = {n}")
    if max(m, n, k) >= 2 ** 31:
        raise ValueError(f"({m}, {k}) x ({n}, {k}) exceeds the kernel's 32-bit sizes")
    from ._build import build, current_stream

    lib = build()
    out = a.new_empty((m, n), dtype=out_dtype)
    lib.call(
        "adv_int8_matmul", a.data_ptr(), w.data_ptr(), 0 if scale is None else scale.data_ptr(),
        out.data_ptr(), m, n, k, MODES[out_dtype], current_stream(a),
    )
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
