"""Models: the i3res50 feature extractor and the three scorer families
(MGFN, RTFM, Sultani), with the JAX package's registry of scorers."""

from __future__ import annotations

import math

import torch
from torch import nn

from .mgfn import MGFN, MGFNConfig, MGFNForVideoAnomalyDetection, MGFNOutput
from .rtfm import RTFM, RTFMConfig, RTFMForVideoAnomalyDetection, RTFMOutput
from .sultani import Sultani, SultaniConfig, SultaniForVideoAnomalyDetection, SultaniOutput

__all__ = [
    "MGFN", "MGFNConfig", "MGFNForVideoAnomalyDetection", "MGFNOutput",
    "RTFM", "RTFMConfig", "RTFMForVideoAnomalyDetection", "RTFMOutput",
    "Sultani", "SultaniConfig", "SultaniForVideoAnomalyDetection", "SultaniOutput",
    "MODEL_REGISTRY", "build_model", "seeded_init_",
]

# scorer name (the configs' runner group) -> (config class, model class)
MODEL_REGISTRY = {
    "mgfn": (MGFNConfig, MGFN),
    "rtfm": (RTFMConfig, RTFM),
    "sultani": (SultaniConfig, Sultani),
}


def build_model(name: str, **config_overrides):
    """(config, model) of a registered scorer, the config built from its
    defaults and ``config_overrides``."""
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(MODEL_REGISTRY)}")
    config_cls, model_cls = MODEL_REGISTRY[name]
    config = config_cls(**config_overrides)
    return config, model_cls(config)


def seeded_init_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights from an explicit generator, reproducible on any device.

    Conv and linear weights draw LeCun-normal values (std 1/sqrt(fan_in),
    the flax default the JAX package initializes with); biases start at
    zero; norm layers keep their identity initialization. Draws happen on
    the CPU, so a seed gives the same weights on the CPU and the card.
    """
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for sub in module.modules():
            if isinstance(sub, (nn.Conv1d, nn.Conv3d, nn.Linear)):
                w = sub.weight
                fan_in = w[0].numel()
                values = torch.randn(w.shape, generator=gen) / math.sqrt(fan_in)
                w.copy_(values.to(w.dtype))
                if sub.bias is not None:
                    sub.bias.zero_()
    return module
