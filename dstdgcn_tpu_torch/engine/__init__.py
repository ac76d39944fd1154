from .engine import PredictionEngine
from .losses import AccumLoss

__all__ = ["PredictionEngine", "AccumLoss"]
