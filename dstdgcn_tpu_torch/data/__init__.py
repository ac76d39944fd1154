from .datasets import MotionDataset, Synthetic, get_dataset
from .loader import Loader

__all__ = ["MotionDataset", "Synthetic", "get_dataset", "Loader"]
