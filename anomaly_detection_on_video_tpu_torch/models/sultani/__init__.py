"""Sultani MIL ranking scorer: eval scores and the training outputs."""

from .config import SultaniConfig
from .model import Sultani, SultaniOutput

# the JAX package's class name, as the repository's configs name it
SultaniForVideoAnomalyDetection = Sultani

__all__ = ["Sultani", "SultaniConfig", "SultaniForVideoAnomalyDetection", "SultaniOutput"]
