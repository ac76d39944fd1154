"""Skeleton graph layouts and adjacency builders (numpy).

The port's own copy of the layout tables and adjacency builders of
``dstdgcn_tpu/graphs/skeleton.py``; held bit-exact against it by
``tests/test_torch_graphs.py``.  A layout holds the dataset-native joint ids
of the bone and semantic "part" edges plus the joints the model consumes.

Adjacency kinds: ``self`` (identity), ``connect`` (identity + symmetric bone
edges), ``part`` (symmetric part edges, no self loops), ``all`` (all three).
:func:`stacked_adjacency` is the (K=2, V, V) ``[connect, part]`` stack the
spatial DSTD-GC ops use.  :func:`edge_list` is the entry point of the sparse
ops (``kernels/sparse.py``); the joint/bone/cross, coordinate-level and
ST-GCN partitioned adjacencies follow it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["SkeletonLayout", "LAYOUTS", "get_layout", "adjacency",
           "stacked_adjacency", "edge_list", "bone_incidence",
           "jbc_adjacency", "flattened_adjacency", "hop_distance",
           "normalize_digraph", "normalize_undigraph", "stgcn_adjacency",
           "joint_bone_transition", "joint_bone_flattened"]


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

    @property
    def kinematic_bones(self) -> np.ndarray:
        """(E', 2) compact-index physical bones (shortcut links dropped)."""
        n = len(self.bone_pairs) - self.num_aux_bones
        return self.remap(self.bone_pairs[:n])


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


def edge_list(adj: np.ndarray) -> np.ndarray:
    """(E, 2) int32 directed edge list of the non-zeros of ``adj``: the
    sparse-op entry point (large graphs go to the ops as edge or block
    lists, not dense matrices)."""
    src, dst = np.nonzero(adj)
    return np.stack([src, dst], axis=-1).astype(np.int32)


def bone_incidence(layout: str | SkeletonLayout) -> np.ndarray:
    """(V, E) signed incidence matrix over the bone edges."""
    lay = get_layout(layout) if isinstance(layout, str) else layout
    bones = lay.bones
    inc = np.zeros((lay.num_joints, len(bones)), np.float32)
    for e, (a, b) in enumerate(bones):
        inc[a, e] = 1.0
        inc[b, e] = -1.0
    return inc


def _layout(layout: str | SkeletonLayout) -> SkeletonLayout:
    return get_layout(layout) if isinstance(layout, str) else layout


def _shares_joint(bones: np.ndarray, i: int, j: int) -> bool:
    return bool(set(bones[i]) & set(bones[j]))


def jbc_adjacency(layout: str | SkeletonLayout, kind: str) -> np.ndarray:
    """Joint/Bone/Cross adjacency over the kinematic-bone graph.

    * ``joint``  (V, V)  identity + symmetric bone edges
    * ``bone``   (E, E)  bones as nodes, an edge between bones that share a
      joint (upper triangle only, not symmetrized)
    * ``cross``  (E, V)  bone -> its two endpoint joints
    """
    lay = _layout(layout)
    bones = lay.kinematic_bones
    v, e = lay.num_joints, len(bones)
    if kind == "joint":
        return _symmetrize(np.eye(v, dtype=np.float32), bones)
    if kind == "bone":
        adj = np.eye(e, dtype=np.float32)
        for i in range(e):
            for j in range(i, e):
                if _shares_joint(bones, i, j):
                    adj[i, j] = 1.0
        return adj
    if kind == "cross":
        adj = np.zeros((e, v), np.float32)
        adj[np.arange(e), bones[:, 0]] = 1.0
        adj[np.arange(e), bones[:, 1]] = 1.0
        return adj
    raise ValueError(f"invalid jbc adjacency kind {kind!r}")


def flattened_adjacency(layout: str | SkeletonLayout, kind: str,
                        dims: int = 3) -> np.ndarray:
    """Coordinate-level (dims*V, dims*V) adjacency, node = (joint, coord).

    * ``joint``       same-coordinate edges along kinematic bones
    * ``coordinate``  clique among the ``dims`` coordinates of each joint
    * ``connection``  same-coordinate complete graph across all joints,
      minus the identity
    """
    lay = _layout(layout)
    v = lay.num_joints
    n = dims * v
    adj = np.zeros((n, n), np.float32)
    if kind == "joint":
        bones = lay.kinematic_bones
        for d in range(dims):
            adj[bones[:, 0] * dims + d, bones[:, 1] * dims + d] = 1.0
            adj[bones[:, 1] * dims + d, bones[:, 0] * dims + d] = 1.0
        return adj
    if kind == "coordinate":
        base = np.arange(v) * dims
        for a in range(dims):
            for b in range(dims):
                if a != b:
                    adj[base + a, base + b] = 1.0
        return adj
    if kind == "connection":
        base = np.arange(v) * dims
        for d in range(dims):
            adj[np.ix_(base + d, base + d)] = 1.0
        return adj - np.eye(n, dtype=np.float32)
    raise ValueError(f"invalid flattened adjacency kind {kind!r}")


def hop_distance(edges: np.ndarray, num_node: int, max_hop: int = 1
                 ) -> np.ndarray:
    """(V, V) graph-hop distance, ``inf`` beyond ``max_hop``, from boolean
    powers of the symmetrized adjacency."""
    adj = np.zeros((num_node, num_node))
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    adj[edges[:, 0], edges[:, 1]] = 1.0
    adj[edges[:, 1], edges[:, 0]] = 1.0
    dist = np.full((num_node, num_node), np.inf)
    reach = np.stack([np.linalg.matrix_power(adj, d) > 0
                      for d in range(max_hop + 1)])
    for d in range(max_hop, -1, -1):
        dist[reach[d]] = d
    return dist


def normalize_digraph(adj: np.ndarray) -> np.ndarray:
    """Column-normalize: ``A @ D^-1``."""
    deg = adj.sum(0)
    inv = np.where(deg > 0, 1.0 / np.where(deg > 0, deg, 1.0), 0.0)
    return adj * inv[None, :]


def normalize_undigraph(adj: np.ndarray) -> np.ndarray:
    """Symmetric normalize: ``D^-1/2 A D^-1/2``."""
    deg = adj.sum(0)
    inv = np.where(deg > 0, np.where(deg > 0, deg, 1.0) ** -0.5, 0.0)
    return inv[:, None] * adj * inv[None, :]


def stgcn_adjacency(layout: str | SkeletonLayout | np.ndarray,
                    strategy: str = "uniform", max_hop: int = 1,
                    dilation: int = 1, center: int = 7,
                    num_node: int | None = None) -> np.ndarray:
    """(K, V, V) ST-GCN partitioned adjacency stack, of a layout (self
    loops and kinematic bones) or an explicit (E, 2) edge list.

    * ``uniform``   K=1: hop-thresholded adjacency, column-normalized
    * ``distance``  one normalized slice per valid hop
    * ``spatial``   root / centripetal / centrifugal partitions by distance
      to ``center`` (hop 0 root only, then (root + closer, further) per hop)
    """
    if isinstance(layout, (str, SkeletonLayout)):
        lay = _layout(layout)
        v = lay.num_joints
        edges = np.concatenate(
            [np.stack([np.arange(v)] * 2, -1), lay.kinematic_bones])
    else:
        edges = np.asarray(layout, dtype=np.int64).reshape(-1, 2)
        if num_node is None:
            num_node = int(edges.max()) + 1
        v = num_node
    dist = hop_distance(edges, v, max_hop=max_hop)
    valid = range(0, max_hop + 1, dilation)
    thresh = np.zeros((v, v))
    for h in valid:
        thresh[dist == h] = 1.0
    norm = normalize_digraph(thresh)
    if strategy == "uniform":
        return norm[None].astype(np.float32)
    if strategy == "distance":
        out = np.zeros((len(list(valid)), v, v))
        for i, h in enumerate(valid):
            out[i][dist == h] = norm[dist == h]
        return out.astype(np.float32)
    if strategy == "spatial":
        to_center = dist[:, center]
        slices = []
        for h in valid:
            on_hop = dist == h
            root = on_hop & (to_center[:, None] == to_center[None, :])
            close = on_hop & (to_center[:, None] > to_center[None, :])
            further = on_hop & (to_center[:, None] < to_center[None, :])
            a_root = np.where(root, norm, 0.0)
            a_close = np.where(close, norm, 0.0)
            a_further = np.where(further, norm, 0.0)
            if h == 0:
                slices.append(a_root)
            else:
                slices.append(a_root + a_close)
                slices.append(a_further)
        return np.stack(slices).astype(np.float32)
    raise ValueError(f"invalid stgcn strategy {strategy!r}")


def joint_bone_transition(layout: str | SkeletonLayout, dims: int = 3
                          ) -> np.ndarray:
    """(V*dims, E*dims) unsigned joint -> bone transition matrix: entry
    ``[j*dims+d, e*dims+d] = 1`` iff joint ``j`` is an endpoint of bone
    ``e``."""
    lay = _layout(layout)
    bones = lay.kinematic_bones
    e = len(bones)
    out = np.zeros((lay.num_joints * dims, e * dims), np.float32)
    for d in range(dims):
        out[bones[:, 0] * dims + d, np.arange(e) * dims + d] = 1.0
        out[bones[:, 1] * dims + d, np.arange(e) * dims + d] = 1.0
    return out


def joint_bone_flattened(layout: str | SkeletonLayout, kind: str,
                         dims: int = 3) -> np.ndarray:
    """Coordinate-level clique adjacency over joints or bones: full
    ``dims x dims`` cliques across connected node pairs plus each node's own
    coordinate clique.

    * ``joint``       (V*dims, V*dims) cliques along kinematic bones
    * ``bone``        (E*dims, E*dims) cliques between bones sharing a joint
    * ``joint-node``  (V, V) identity + symmetric bone edges
    * ``bone-node``   (E, E) identity + upper-triangular shared-joint edges
    """
    lay = _layout(layout)
    bones = lay.kinematic_bones
    v, e = lay.num_joints, len(bones)

    def clique(adj, a, b):
        for i in range(dims):
            for j in range(dims):
                adj[a * dims + i, b * dims + j] = 1.0
                adj[b * dims + i, a * dims + j] = 1.0
                adj[a * dims + i, a * dims + j] = 1.0
                adj[b * dims + i, b * dims + j] = 1.0

    if kind == "joint":
        adj = np.eye(v * dims, dtype=np.float32)
        for a, b in bones:
            clique(adj, a, b)
        return adj
    if kind == "bone":
        adj = np.eye(e * dims, dtype=np.float32)
        for i in range(e):
            for j in range(i, e):
                if _shares_joint(bones, i, j):
                    clique(adj, i, j)
        return adj
    if kind == "joint-node":
        return _symmetrize(np.eye(v, dtype=np.float32), bones)
    if kind == "bone-node":
        return jbc_adjacency(lay, "bone")
    raise ValueError(f"invalid joint-bone flattened kind {kind!r}")
