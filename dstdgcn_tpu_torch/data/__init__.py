from . import (datasets, kinematics, loader, native, pose_norm, traffic,
               transforms)
from .datasets import (CMUMocap, Human36M, MotionDataset, PW3D, Synthetic,
                       define_actions, get_dataset)
from .loader import Loader
from .transforms import (MeanStdNorm, MinMaxNorm, TimeTransform,
                         get_transform, mirror_sequences, padding_indices)

__all__ = [
    "datasets", "kinematics", "loader", "native", "pose_norm", "traffic",
    "transforms",
    "CMUMocap", "Human36M", "MotionDataset", "PW3D", "Synthetic",
    "define_actions", "get_dataset", "Loader", "MeanStdNorm", "MinMaxNorm",
    "TimeTransform", "get_transform", "mirror_sequences", "padding_indices",
]
