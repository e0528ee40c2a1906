"""Training and eval runtime of the port."""

from .runner import EvalResult, TrainState, VideoAnomalyDetectionRunner

__all__ = ["EvalResult", "TrainState", "VideoAnomalyDetectionRunner"]
