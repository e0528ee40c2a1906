"""MGFN anomaly scorer: eval scores and the training outputs."""

from .config import MGFNConfig
from .model import MGFN, MGFNModel, MGFNOutput

# the JAX package's class name, as the repository's configs name it
MGFNForVideoAnomalyDetection = MGFN

__all__ = ["MGFN", "MGFNConfig", "MGFNForVideoAnomalyDetection", "MGFNModel", "MGFNOutput"]
