"""Symmetric int8 quantization of the i3res50 convs.

The arithmetic of the JAX package's ``ConvBN._int8_conv`` (its
``models/i3d.py``), in torch:

- weights per output channel: ``w_scale = max(absmax, 1e-12) / 127`` and
  ``w_q = clip(round(w / w_scale), -127, 127)``, in float32;
- activations by a static calibrated scale ``s``:
  ``clip(round(float32(x) * float32(1 / s)), -127, 127)``;
- the int32 conv sum dequantizes by ``w_scale * float32(s)``.

``round`` is round half to even throughout, as in numpy and JAX. The int8
products themselves run in kernels K4 (``kernels/int8_matmul.py``) and K5
(``kernels/int8_conv.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

QMAX = 127


def quantize_weight(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch conv weight ``(O, I, kt, kh, kw)`` -> ``(w_q int8, w_scale
    float32 (O,))``, the scale from each output channel's absmax."""
    w = weight.detach().float()
    w_scale = torch.clamp(w.abs().amax(dim=tuple(range(1, w.dim()))), min=1e-12) / float(QMAX)
    w_q = torch.clamp(torch.round(w / w_scale.view(-1, *([1] * (w.dim() - 1)))), -QMAX, QMAX)
    return w_q.to(torch.int8), w_scale


def quantize_activation(x: torch.Tensor, act_scale: float) -> torch.Tensor:
    """``x`` (any float type) -> int8 by the static scale ``act_scale``; the
    reciprocal is rounded to float32 once, and ``x`` is widened to float32
    before the multiply."""
    inv = torch.tensor(1.0 / act_scale, dtype=torch.float32)
    return torch.clamp(torch.round(x.float() * inv), -QMAX, QMAX).to(torch.int8)


def dequant_scale(w_scale: torch.Tensor, act_scale: float) -> torch.Tensor:
    """Per-output-channel float32 factor that turns the int32 sum back
    into the conv's value: ``w_scale * float32(act_scale)``."""
    return w_scale * torch.tensor(act_scale, dtype=torch.float32, device=w_scale.device)


def pack_int8_weight_nk(w_q: torch.Tensor) -> torch.Tensor:
    """int8 ``(O, I, kt, kh, kw)`` -> the kernels' ``(O, kt*kh*kw*I)``
    matrix, each output channel's row K-contiguous, ordered (kt, kh, kw,
    cin); ``(O, I)`` for a 1x1x1 conv. K4 takes it for every 1x1x1 conv, K5
    (``kernels/int8_conv.pack_int8_conv_weight``) for every conv but the
    stem."""
    return w_q.permute(0, 2, 3, 4, 1).reshape(w_q.shape[0], -1).contiguous()


def scale_epilogue(acc: torch.Tensor, scale: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """The kernels' epilogue in torch ops: ``float32(acc) * scale`` along
    the last axis, rounded once into ``out_dtype``; int8 requantizes with
    round half to even and a clamp to [-127, 127]."""
    y = acc.float() * scale
    if out_dtype == torch.int8:
        return torch.clamp(torch.round(y), -QMAX, QMAX).to(torch.int8)
    return y.to(out_dtype)


def check_epilogue(scale: Optional[torch.Tensor], n: int, out_dtype, allowed, device) -> None:
    """Raise unless ``scale`` is a float32 ``(n,)`` vector on ``device`` and
    ``out_dtype`` is one of ``allowed``."""
    if out_dtype not in allowed:
        raise ValueError(f"out_dtype must be one of {allowed}, got {out_dtype}")
    if scale is None:
        return
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,) or not scale.is_contiguous():
        raise ValueError(f"scale must be float32 ({n},), got {scale.dtype} {tuple(scale.shape)}")
    if scale.device != device:
        raise ValueError(f"scale on {scale.device}, activations on {device}")
