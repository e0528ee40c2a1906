"""Device resolution and float32 parity settings.

Entry points take an explicit ``device`` argument that defaults to
``"cuda"``: the port runs on the card unless the caller asks for the CPU.
Nothing here looks at ``torch.cuda.is_available()`` to pick a device.
"""

from __future__ import annotations

import contextlib
import threading
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


_F32_LOCK = threading.Lock()
_f32_users = 0  # blocks inside full_f32, on any thread
_f32_saved = (False, True)  # the flags the first of them found


@contextlib.contextmanager
def full_f32() -> Iterator[None]:
    """TF32 off for cuBLAS and cuDNN inside the block, restored after.

    The flags are process-wide, and the extractors' threads enter such
    blocks at once (a device flow beside another stream's resize): the
    flags are restored when the last open block on any thread exits, so no
    thread's block ends another's."""
    global _f32_users, _f32_saved
    with _F32_LOCK:
        if _f32_users == 0:
            _f32_saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            set_f32_parity()
        _f32_users += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _f32_users -= 1
            if _f32_users == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _f32_saved

