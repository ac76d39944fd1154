from .engine import PredictionEngine, steplr
from .losses import AccumLoss

__all__ = ["PredictionEngine", "AccumLoss", "steplr"]
