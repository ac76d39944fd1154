"""Skeleton graph layouts and adjacency builders (numpy).

The port's own copy of the layout tables and adjacency builders of
``dstdgcn_tpu/graphs/skeleton.py``; held bit-exact against it by
``tests/test_torch_graphs.py``.  A layout holds the dataset-native joint ids
of the bone and semantic "part" edges plus the joints the model consumes.

Adjacency kinds: ``self`` (identity), ``connect`` (identity + symmetric bone
edges), ``part`` (symmetric part edges, no self loops), ``all`` (all three).
:func:`stacked_adjacency` is the (K=2, V, V) ``[connect, part]`` stack the
spatial DSTD-GC ops use.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["SkeletonLayout", "LAYOUTS", "get_layout", "adjacency",
           "stacked_adjacency", "bone_incidence"]


@dataclasses.dataclass(frozen=True)
class SkeletonLayout:
    """A skeleton topology in dataset-native joint indexing."""

    name: str
    #: joints (dataset-native ids) the model consumes, in model order
    used_joints: Tuple[int, ...]
    #: kinematic bone edges (dataset-native ids)
    bone_pairs: Tuple[Tuple[int, int], ...]
    #: semantic part edges: mirror-symmetry and limb-coordination pairs
    part_pairs: Tuple[Tuple[int, int], ...]
    #: mirror augmentation: (right, left) joint id lists over the FULL skeleton
    mirror_right: Tuple[int, ...] = ()
    mirror_left: Tuple[int, ...] = ()
    #: total joints in the full (un-reduced) skeleton
    full_joints: int = 0
    #: trailing entries of ``bone_pairs`` that are shortcut links, not bones
    num_aux_bones: int = 0

    @property
    def num_joints(self) -> int:
        return len(self.used_joints)

    @property
    def index_map(self) -> Dict[int, int]:
        """dataset-native joint id -> compact model index."""
        return {j: i for i, j in enumerate(self.used_joints)}

    def remap(self, pairs: Sequence[Tuple[int, int]]) -> np.ndarray:
        m = self.index_map
        return np.asarray([[m[a], m[b]] for a, b in pairs], dtype=np.int32)

    @property
    def bones(self) -> np.ndarray:
        """(E, 2) compact-index bone edges."""
        return self.remap(self.bone_pairs)

    @property
    def parts(self) -> np.ndarray:
        """(E, 2) compact-index part edges."""
        return self.remap(self.part_pairs)


_H36M = SkeletonLayout(
    name="h36m",
    used_joints=(2, 3, 4, 5, 7, 8, 9, 10, 12, 13, 14, 15, 17, 18, 19, 21, 22,
                 25, 26, 27, 29, 30),
    bone_pairs=(
        (5, 4), (10, 9), (4, 3), (9, 8), (3, 2), (8, 7),
        (13, 12), (14, 12), (21, 19), (22, 19), (19, 18),
        (29, 27), (30, 27), (27, 26), (18, 17), (26, 25),
        (17, 13), (25, 13), (14, 13), (15, 14),
        # torso-to-hip shortcut links
        (2, 12), (7, 12),
    ),
    part_pairs=(
        # left/right mirror pairs
        (17, 25), (18, 26), (19, 27), (21, 29), (22, 30),
        (2, 7), (3, 8), (4, 9), (5, 10),
        # arm <-> leg coordination
        (18, 2), (26, 7), (18, 7), (26, 2),
        (19, 3), (27, 8), (19, 8), (27, 3),
    ),
    mirror_right=(1, 2, 3, 4, 5, 16, 17, 18, 19, 20, 21, 22, 23),
    mirror_left=(6, 7, 8, 9, 10, 24, 25, 26, 27, 28, 29, 30, 31),
    full_joints=32,
    num_aux_bones=2,
)

_CMU = SkeletonLayout(
    name="cmu",
    used_joints=(3, 4, 5, 6, 9, 10, 11, 12, 14, 15, 17, 18, 19, 21, 22, 23,
                 25, 26, 28, 30, 31, 32, 34, 35, 37),
    bone_pairs=(
        # legs/feet
        (6, 5), (5, 4), (4, 3), (10, 9), (11, 10), (12, 11),
        # torso/head
        (15, 14), (17, 15), (18, 17), (19, 18),
        # arms
        (30, 15), (31, 30), (32, 31), (34, 32), (35, 34), (37, 32),
        (26, 25), (25, 23), (28, 23), (23, 22), (22, 21), (21, 15),
        # hip shortcut links
        (9, 14), (3, 14),
    ),
    part_pairs=(
        # mirror
        (30, 21), (31, 22), (32, 23), (37, 28), (34, 25), (35, 26),
        (9, 3), (10, 4), (11, 5), (12, 4),
        # arm refinement
        (21, 23), (21, 25), (21, 26), (21, 28), (25, 28), (26, 28),
        (30, 32), (30, 34), (30, 35), (30, 37), (34, 37), (35, 37),
        (22, 30), (21, 31), (23, 31), (22, 32),
        # leg refinement
        (3, 5), (3, 6), (4, 6), (9, 11), (9, 12), (10, 12), (4, 9), (3, 10),
        # leg <-> arm coordination
        (31, 9), (22, 3), (32, 10), (23, 4), (31, 3), (23, 9), (22, 10),
        (31, 4), (32, 9), (32, 3), (23, 3),
    ),
    mirror_right=(2, 3, 4, 5, 6, 21, 22, 23, 24, 27, 25, 26, 28),
    mirror_left=(8, 9, 10, 11, 12, 30, 31, 32, 33, 36, 24, 35, 37),
    full_joints=38,
    num_aux_bones=2,
)

_3DPW = SkeletonLayout(
    name="3dpw",
    used_joints=tuple(range(1, 24)),
    bone_pairs=(
        # legs
        (1, 4), (4, 7), (7, 10), (2, 5), (5, 8), (8, 11),
        # torso
        (1, 3), (2, 3), (3, 6), (6, 9), (9, 12), (9, 13), (9, 14),
        (12, 13), (12, 14), (12, 15),
        # arms
        (13, 16), (14, 17), (16, 18), (17, 19), (18, 20), (19, 21),
        (20, 22), (21, 23),
    ),
    part_pairs=(
        # mirror
        (1, 2), (4, 5), (7, 8), (10, 11), (13, 14), (16, 17), (18, 19),
        (20, 21), (22, 23),
        # leg <-> arm coordination
        (16, 1), (16, 2), (14, 1), (14, 2), (18, 4), (18, 5), (19, 4),
        (19, 5), (20, 7), (20, 8), (21, 7), (21, 8),
    ),
    mirror_right=(1, 4, 7, 10, 13, 16, 18, 20, 22),
    mirror_left=(2, 5, 8, 11, 14, 17, 19, 21, 23),
    full_joints=24,
)

LAYOUTS: Dict[str, SkeletonLayout] = {
    "h36m": _H36M,
    "cmu": _CMU,
    "3dpw": _3DPW,
}


def get_layout(name: str) -> SkeletonLayout:
    try:
        return LAYOUTS[name]
    except KeyError:
        raise NotImplementedError(f"unknown skeleton layout {name!r}") from None


def _symmetrize(adj: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    if len(pairs):
        adj[pairs[:, 0], pairs[:, 1]] = 1.0
        adj[pairs[:, 1], pairs[:, 0]] = 1.0
    return adj


def adjacency(layout: str | SkeletonLayout, kind: str = "all") -> np.ndarray:
    """(V, V) float32 adjacency of the requested kind."""
    lay = get_layout(layout) if isinstance(layout, str) else layout
    v = lay.num_joints
    if kind == "self":
        return np.eye(v, dtype=np.float32)
    if kind == "connect":
        return _symmetrize(np.eye(v, dtype=np.float32), lay.bones)
    if kind == "part":
        return _symmetrize(np.zeros((v, v), np.float32), lay.parts)
    if kind == "all":
        adj = _symmetrize(np.eye(v, dtype=np.float32), lay.bones)
        return _symmetrize(adj, lay.parts)
    raise ValueError(f"invalid adjacency kind {kind!r}")


def stacked_adjacency(layout: str | SkeletonLayout) -> np.ndarray:
    """(2, V, V) stack of [connect, part] adjacencies."""
    return np.stack([adjacency(layout, "connect"), adjacency(layout, "part")])


def bone_incidence(layout: str | SkeletonLayout) -> np.ndarray:
    """(V, E) signed incidence matrix over the bone edges."""
    lay = get_layout(layout) if isinstance(layout, str) else layout
    bones = lay.bones
    inc = np.zeros((lay.num_joints, len(bones)), np.float32)
    for e, (a, b) in enumerate(bones):
        inc[a, e] = 1.0
        inc[b, e] = -1.0
    return inc
