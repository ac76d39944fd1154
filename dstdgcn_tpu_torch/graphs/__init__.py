from . import skeleton, temporal
from .skeleton import (LAYOUTS, SkeletonLayout, adjacency, bone_incidence,
                       get_layout, stacked_adjacency)

__all__ = ["skeleton", "temporal", "LAYOUTS", "SkeletonLayout", "adjacency",
           "bone_incidence", "get_layout", "stacked_adjacency"]
