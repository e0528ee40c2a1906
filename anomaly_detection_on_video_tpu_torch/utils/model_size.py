"""Model size diagnostics (counterpart of the JAX package's
``utils/model_size.py``; reference: ``src/i3d.py:321-329``
``print_model_size``, whose integer branch has a ``.gits`` typo, fixed
here)."""

from __future__ import annotations

from typing import Mapping, Tuple, Union

import torch
from torch import nn

# the buffers a state dict holds beside the parameters (BatchNorm statistics)
BUFFER_NAMES = ("running_mean", "running_var", "num_batches_tracked")


def model_size_bits(model: Union[nn.Module, Mapping[str, torch.Tensor]]) -> Tuple[int, int]:
    """(n_params, total_bits) over a module's parameters, or over the
    parameters of a state dict. As the reference's ``parameters()`` loop
    and the JAX package's count of the ``params`` collection, buffers are
    excluded: a state dict's BatchNorm statistics (``BUFFER_NAMES``) are
    skipped."""
    if isinstance(model, nn.Module):
        tensors = list(model.parameters())
    else:
        tensors = [t for name, t in model.items() if name.rsplit(".", 1)[-1] not in BUFFER_NAMES]
    n_params = 0
    total_bits = 0
    for p in tensors:
        bits = torch.finfo(p.dtype).bits if p.dtype.is_floating_point else torch.iinfo(p.dtype).bits
        n_params += p.numel()
        total_bits += p.numel() * bits
    return n_params, total_bits


def print_model_size(model: Union[nn.Module, Mapping[str, torch.Tensor]]) -> str:
    """Print (and return) the reference's size line:
    ``model size: <bits> / bit | <MB> / MB``."""
    _, bits = model_size_bits(model)
    line = f"model size: {bits} / bit | {bits / 8e6:.2f} / MB"
    print(line)
    return line
