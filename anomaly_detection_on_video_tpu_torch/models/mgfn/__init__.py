"""MGFN anomaly scorer (eval path)."""

from .config import MGFNConfig
from .model import MGFN, MGFNModel

__all__ = ["MGFN", "MGFNConfig", "MGFNModel"]
