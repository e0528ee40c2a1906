"""K5: int8 3D convolution, channels last, with a per-channel scale epilogue.

Replaces ``make_conv3x3`` / ``_conv3x3_kernel``
(scripts/int8_pallas_probe.py:159 / :116): an int8 3x3 conv with zero
padding, int32 accumulation, and a per-output-channel float32 scale whose
product is either requantized to int8 (``clip(round(.), -127, 127)``, round
half to even) or written as bfloat16. Generalized to the I3D int8 paths'
geometries (k(1,3,3) with stride 1 or 2 and k(3,1,1) over Cin % 16 == 0
channels; the stem's k(5,7,7) p(2,3,3) at stride (2,2,2), i3res50's, or
(1,2,2), i3d_8x8_r50's, over 3 channels, or over 2 for the flow stream)
and to a float32 output.

On the H100 it is bound by operations for the k(1,3,3) convs and by bytes
for the k(3,1,1) convs and the stem: about 0.57 ms for the 26 convs of an
int8 forward at B = 40. The CUDA kernels (``csrc/int8_conv.cu``) run on
the tensor cores and gather their A tiles from the activation, so no
im2col copy reaches device memory. For Cin % 16 == 0, an implicit GEMM on
``wgmma`` s32.s8.s8 whose 16-byte A pieces and (Cout, K) weight rows
arrive by ``cp.async`` in a 3-4 stage ring of 128-byte-swizzled tiles. For
the stem, ``mma.sync`` fed by ``ldmatrix`` from a slab that holds the
C-channel input (C = 3, or 2 for flow) once as one 32-byte vector per pixel
(two stem frames x 5 temporal taps x C channels, zero-padded to 16 bytes
each), two (kh, kw) taps per k32 step against the (64, 800) operand of
``pack_int8_conv_weight``. The temporal stride only changes which input
frames a CTA's two stem frames read (6 at stride 1, 7 at stride 2): the
slab, the weights and the products are the same. A 2-channel input is read as it is, never padded
to a third channel: the padding would copy the largest int8 tensor of the
forward to multiply zeros. Any other geometry raises on the card. The
plain version is ``F.conv3d`` in float64 on the int8 values, exact for the
path's sums.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..quant import check_epilogue, pack_int8_weight_nk, scale_epilogue
from .int8_matmul import MODES

Triple = Tuple[int, int, int]

STEM_KERNEL = (5, 7, 7)  # a k(5,7,7) weight over STEM_CHANNELS is packed in the stem layout
STEM_CHANNELS = (2, 3)  # flow (dx, dy) and RGB
# the stem kernel's geometries: (kernel, stride, padding) of i3res50 and i3d_8x8_r50
STEM_GEOMETRY = {(STEM_KERNEL, (2, 2, 2), (2, 3, 3)), (STEM_KERNEL, (1, 2, 2), (2, 3, 3))}
STEM_STRIDES = (1, 2)  # the temporal strides of STEM_GEOMETRY
STEM_TAPS = 7 * 7
STEM_TAP_K = 16  # bytes per (kh, kw) tap: 5 temporal taps x C channels, padded
STEM_K = (STEM_TAPS + 1) * STEM_TAP_K  # 800: 25 k32 steps of two taps, the 50th zero
MAX_POSITIONS = 2 ** 31 - 1 - 128  # B*To*Ho*Wo: a 32-bit row index plus one 128-row tile


def _triple(v: Sequence[int], name: str) -> Triple:
    v = tuple(int(i) for i in v)
    if len(v) != 3:
        raise ValueError(f"{name} must have three entries, got {v}")
    return v


def conv_output_shape(shape, kernel: Triple, stride: Triple, padding: Triple) -> Triple:
    """(To, Ho, Wo) of a conv over (T, H, W)."""
    return tuple((n + 2 * p - k) // s + 1 for n, k, s, p in zip(shape, kernel, stride, padding))


def _stem_layout(cin: int, kernel: Sequence[int]) -> bool:
    return cin in STEM_CHANNELS and tuple(kernel) == STEM_KERNEL


def _packed_k(cin: int, kernel: Sequence[int]) -> int:
    """K of the packed operand: ``STEM_K`` in the stem layout, else
    kt*kh*kw*cin."""
    return STEM_K if _stem_layout(cin, kernel) else kernel[0] * kernel[1] * kernel[2] * cin


def pack_int8_conv_weight(w_q: torch.Tensor) -> torch.Tensor:
    """int8 ``(O, I, kt, kh, kw)`` -> K5's ``(O, K)`` operand, each output
    channel's row K-contiguous. A k(5,7,7) weight over C = 3 or 2 channels
    (the stem) takes the stem kernel's layout, ``(O, 800)``: 49 (kh, kw)
    taps of 16 bytes ``[kt * C + c]`` (bytes 5 * C .. 15 zero), then one zero
    tap, so one k32 step holds two taps. Any other weight is ``pack_int8_weight_nk``'s
    ``(O, kt*kh*kw*I)``, rows (kt, kh, kw, cin)."""
    o, cin = w_q.shape[:2]
    if not _stem_layout(cin, w_q.shape[2:]):
        return pack_int8_weight_nk(w_q)
    taps = w_q.permute(0, 3, 4, 2, 1).reshape(o, STEM_TAPS, 5 * cin)
    taps = F.pad(taps, (0, STEM_TAP_K - 5 * cin, 0, 1))
    return taps.reshape(o, STEM_K).contiguous()


def unpack_int8_conv_weight(w_packed: torch.Tensor, cin: int, kernel: Triple) -> torch.Tensor:
    """``pack_int8_conv_weight``'s operand -> the torch ``(O, I, kt, kh, kw)``
    weight."""
    o = w_packed.shape[0]
    if _stem_layout(cin, kernel):
        taps = w_packed.reshape(o, STEM_TAPS + 1, STEM_TAP_K)[:, :STEM_TAPS, :5 * cin]
        return taps.reshape(o, 7, 7, 5, cin).permute(0, 4, 3, 1, 2)
    return w_packed.reshape(o, *kernel, cin).permute(0, 4, 1, 2, 3)


def int8_conv_plain(x, w_packed, scale, kernel, stride, padding, out_dtype) -> torch.Tensor:
    """Plain version, on any device: ``F.conv3d`` in float64 on the int8
    values, cast to int32, then the same epilogue in torch ops."""
    kernel, stride, padding = (_triple(v, n) for v, n in
                               ((kernel, "kernel"), (stride, "stride"), (padding, "padding")))
    w = unpack_int8_conv_weight(w_packed, x.shape[-1], kernel).double()
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
    ``w_packed``, the int8 ``(Cout, K)`` operand of
    ``pack_int8_conv_weight``, its int32 sum times the float32 ``(Cout,)``
    ``scale``. A CPU tensor takes the plain version (any geometry); a CUDA
    tensor launches a kernel, which takes Cin % 16 == 0 with Cout % 16 == 0,
    or the stem (Cin = 3 or 2, k(5,7,7), s(2,2,2) or s(1,2,2), p(2,3,3),
    Cout = 64, W % 4 == 0 and ``x`` 4-byte aligned, so each row load of four
    pixels is C whole 4-byte words), and anything else raises.
    """
    kernel, stride, padding = (_triple(v, n) for v, n in
                               ((kernel, "kernel"), (stride, "stride"), (padding, "padding")))
    if scale is None:
        raise ValueError("int8_conv needs a per-channel scale")
    if x.dtype != torch.int8 or w_packed.dtype != torch.int8:
        raise ValueError(f"int8_conv takes int8 operands, got {x.dtype} and {w_packed.dtype}")
    if x.dim() != 5 or w_packed.dim() != 2:
        raise ValueError(f"expected (B, T, H, W, Cin) and (Cout, K), got {tuple(x.shape)} "
                         f"and {tuple(w_packed.shape)}")
    b, t, h, w, cin = x.shape
    if w_packed.shape[1] != _packed_k(cin, kernel):
        raise ValueError(f"weights {tuple(w_packed.shape)} do not match kernel {kernel} "
                         f"over {cin} channels")
    if min(stride) < 1 or min(padding) < 0 or min(kernel) < 1:
        raise ValueError(f"bad geometry: kernel {kernel}, stride {stride}, padding {padding}")
    out_shape = conv_output_shape((t, h, w), kernel, stride, padding)
    if min(out_shape) < 1:
        raise ValueError(f"kernel {kernel} does not fit the padded input {tuple(x.shape)}")
    cout = w_packed.shape[0]
    check_epilogue(scale, cout, out_dtype, (torch.int8, torch.float32, torch.bfloat16), x.device)
    if w_packed.device != x.device:
        raise ValueError(f"operands on {x.device} and {w_packed.device}")
    if x.device.type == "cpu":
        return int8_conv_plain(x, w_packed, scale, kernel, stride, padding, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w_packed.is_contiguous()):
        raise ValueError("int8_conv operands must be contiguous")
    if _stem_layout(cin, kernel):
        if (kernel, stride, padding) not in STEM_GEOMETRY or cout != 64 or w % 4 or x.data_ptr() % 4:
            raise ValueError(f"the stem kernel takes k{STEM_KERNEL} s(2,2,2) or s(1,2,2) p(2,3,3) over "
                             f"{STEM_CHANNELS} channels into 64 over a width that is a multiple "
                             f"of 4 from a 4-byte aligned input, got kernel {kernel}, "
                             f"stride {stride}, padding {padding}, {cout} channels, "
                             f"input {tuple(x.shape)}")
    elif cin % 16 or cout % 16 or x.data_ptr() % 16:
        raise ValueError(f"int8_conv on the card takes Cin and Cout multiples of 16 (or the "
                         f"stem), got {cin} -> {cout}")
    if w_packed.data_ptr() % 16:
        raise ValueError("int8_conv weights must be 16-byte aligned")
    # element offsets are 64-bit in the kernels; output positions are 32-bit
    # row indices, and the stem's grid holds B * ceil(To / 2) planes in z
    positions = b * out_shape[0] * out_shape[1] * out_shape[2]
    if positions > MAX_POSITIONS:
        raise ValueError(f"{tuple(x.shape)} gives {positions} output positions, more than the "
                         f"kernel's {MAX_POSITIONS}")
    if _stem_layout(cin, kernel) and b * ((out_shape[0] + 1) // 2) > 65535:
        raise ValueError(f"batch {b} exceeds the stem kernel's launch grid")
    from ._build import build, current_stream

    lib = build()
    out = x.new_empty((b, *out_shape, cout), dtype=out_dtype)
    lib.call(
        "adv_int8_conv", x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
        b, t, h, w, cin, cout, *kernel, *stride, *padding, MODES[out_dtype],
        current_stream(x),
    )
    int8_conv.launches += 1
    if _stem_layout(cin, kernel):
        int8_conv.stem_launches[cin] += 1
        int8_conv.stem_stride_launches[stride[0]] += 1
    return out


int8_conv.launches = 0
# the stem's share of ``launches``, by input channels (3: RGB, 2: flow) and
# by temporal stride (2: i3res50, 1: i3d_8x8_r50)
int8_conv.stem_launches = dict.fromkeys(STEM_CHANNELS, 0)
int8_conv.stem_stride_launches = dict.fromkeys(STEM_STRIDES, 0)
