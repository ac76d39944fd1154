from . import road, skeleton, temporal
from .skeleton import (LAYOUTS, SkeletonLayout, adjacency, bone_incidence,
                       edge_list, get_layout, hop_distance,
                       joint_bone_flattened, joint_bone_transition,
                       normalize_digraph, normalize_undigraph,
                       stacked_adjacency, stgcn_adjacency)

__all__ = [
    "road", "skeleton", "temporal", "LAYOUTS", "SkeletonLayout", "adjacency",
    "bone_incidence", "edge_list", "get_layout", "stacked_adjacency",
    "hop_distance", "normalize_digraph", "normalize_undigraph",
    "stgcn_adjacency", "joint_bone_transition", "joint_bone_flattened",
]
