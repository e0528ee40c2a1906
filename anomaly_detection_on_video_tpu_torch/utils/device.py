"""Device resolution and float32 parity settings.

Entry points take an explicit ``device`` argument that defaults to
``"cuda"``: the port runs on the card unless the caller asks for the CPU.
Nothing here looks at ``torch.cuda.is_available()`` to pick a device.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"`` / ``"cpu"`` / ``torch.device`` -> ``torch.device``.

    Asking for CUDA on a host without a card raises here, not later in the
    middle of a forward.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch sees no CUDA device; pass "
            "device='cpu' to run the plain versions on the CPU"
        )
    return device


def set_f32_parity() -> None:
    """Full float32 products everywhere (TF32 off for cuBLAS and cuDNN).

    cuDNN convolutions default to TF32 on Ampere and later, which keeps
    about three decimal digits; parity runs against the JAX reference and
    the exact resize need true float32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """TF32 off for cuBLAS and cuDNN inside the block, restored after."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    set_f32_parity()
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

