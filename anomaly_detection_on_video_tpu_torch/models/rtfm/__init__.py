"""RTFM scorer: eval scores and the training outputs."""

from .config import RTFMConfig
from .model import RTFM, RTFMOutput

# the JAX package's class name, as the repository's configs name it
RTFMForVideoAnomalyDetection = RTFM

__all__ = ["RTFM", "RTFMConfig", "RTFMForVideoAnomalyDetection", "RTFMOutput"]
