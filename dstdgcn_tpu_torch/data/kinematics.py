"""Rotation conversions and forward kinematics (numpy).

Counterpart of ``dstdgcn_tpu/data/kinematics.py``, kept in numpy with the
same operations in the same order, so the joint positions equal the JAX
package's byte for byte.  The skeleton tables are grouped into
*topological levels* (all joints whose parents are already resolved), so
forward kinematics is a short loop over levels with batched ``(F, 3, 3)``
products over frames and joints inside each level.

Semantics of the data the datasets were generated with:
  * expmap -> rotmat uses the epsilon-regularized axis
    (``r / (||r|| + 1e-7)``), not the mathematically exact formula;
  * joints whose parent is the root keep their local rotation/offset
    (valid because the loaders zero the global rotation/translation
    first);
  * row-vector convention: ``xyz_child = offset @ R_parent + xyz_parent``,
    ``R_child = R_local @ R_parent``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

__all__ = [
    "expmap_to_rotmat", "rotmat_to_euler", "rotmat_to_quat",
    "quat_to_expmap", "expmap_to_quat",
    "Skeleton", "h36m_skeleton", "cmu_skeleton", "forward_kinematics",
    "expmap_to_xyz",
]


# ---------------------------------------------------------------------------
# batched rotation conversions (numpy, vectorized over leading axes)
# ---------------------------------------------------------------------------

def expmap_to_rotmat(r: np.ndarray) -> np.ndarray:
    """(..., 3) axis-angle -> (..., 3, 3) rotation (Rodrigues).

    Matches torch ``expmap2rotmat_torch`` (utils.py:687-708) including the
    1e-7 normalization epsilon.
    """
    r = np.asarray(r, np.float32)
    theta = np.linalg.norm(r, axis=-1, keepdims=True)
    r0 = r / (theta + 1e-7)
    zeros = np.zeros_like(r0[..., 0])
    rx, ry, rz = r0[..., 0], r0[..., 1], r0[..., 2]
    k = np.stack([
        np.stack([zeros, -rz, ry], -1),
        np.stack([rz, zeros, -rx], -1),
        np.stack([-ry, rx, zeros], -1),
    ], -2)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), k.shape)
    s = np.sin(theta)[..., None]
    c = (1 - np.cos(theta))[..., None]
    return eye + s * k + c * (k @ k)


def rotmat_to_quat(rm: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 4) unit quaternion (w, x, y, z).

    Matches ``rotmat2quat_torch`` (utils.py:644-668)."""
    rotdiff = rm - np.swapaxes(rm, -1, -2)
    r = np.stack([-rotdiff[..., 1, 2], rotdiff[..., 0, 2],
                  -rotdiff[..., 0, 1]], -1)
    r_norm = np.linalg.norm(r, axis=-1)
    sintheta = r_norm / 2.0
    r0 = r / (r_norm[..., None] + 1e-8)
    costheta = (np.trace(rm, axis1=-2, axis2=-1) - 1.0) / 2.0
    theta = np.arctan2(sintheta, costheta)
    q = np.concatenate([np.cos(theta / 2)[..., None],
                        r0 * np.sin(theta / 2)[..., None]], -1)
    return q


def quat_to_expmap(q: np.ndarray) -> np.ndarray:
    """(..., 4) -> (..., 3), matches ``quat2expmap`` (utils.py:96-124)."""
    sinhalf = np.linalg.norm(q[..., 1:], axis=-1)
    coshalf = q[..., 0]
    theta = 2 * np.arctan2(sinhalf, coshalf)
    theta = np.mod(theta + 2 * np.pi, 2 * np.pi)
    big = theta > np.pi
    theta = np.where(big, 2 * np.pi - theta, theta)
    r0 = q[..., 1:] / (sinhalf[..., None] + 1e-32)
    r0 = np.where(big[..., None], -r0, r0)
    return r0 * theta[..., None]


def expmap_to_quat(r: np.ndarray) -> np.ndarray:
    """(..., 3) -> (..., 4), matches ``expmap2quat_torch``."""
    theta = np.linalg.norm(r, axis=-1, keepdims=True)
    v = r / (theta + 1e-7)
    return np.concatenate([np.cos(theta / 2), v * np.sin(theta / 2)], -1)


def rotmat_to_euler(rm: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 3) Euler, matches ``rotmat2euler_torch``."""
    r02 = rm[..., 0, 2]
    e1 = -np.arcsin(np.clip(r02, -1, 1))
    cos_e1 = np.cos(e1)
    e0 = np.arctan2(rm[..., 1, 2] / cos_e1, rm[..., 2, 2] / cos_e1)
    e2 = np.arctan2(rm[..., 0, 1] / cos_e1, rm[..., 0, 0] / cos_e1)
    eul = np.stack([e0, e1, e2], -1)
    spec1 = r02 == 1
    spec2 = r02 == -1
    if spec1.any() or spec2.any():
        delta = np.arctan2(rm[..., 0, 1], rm[..., 0, 2])
        eul = np.where(spec1[..., None],
                       np.stack([delta, np.full_like(delta, -np.pi / 2),
                                 np.zeros_like(delta)], -1), eul)
        eul = np.where(spec2[..., None],
                       np.stack([delta, np.full_like(delta, np.pi / 2),
                                 np.zeros_like(delta)], -1), eul)
    return eul


# ---------------------------------------------------------------------------
# skeleton tables + forward kinematics
# ---------------------------------------------------------------------------

class Skeleton(NamedTuple):
    """FK tables: parents (J,), bone offsets (J, 3), expmap channel index
    (J,) start positions into the angle vector."""

    parents: np.ndarray
    offsets: np.ndarray
    expmap_ind: np.ndarray
    #: joints grouped by topological depth (root at level 0)
    levels: Tuple[np.ndarray, ...]


def _levels(parents: np.ndarray) -> Tuple[np.ndarray, ...]:
    depth = np.zeros(len(parents), np.int64)
    for j in range(len(parents)):
        p = parents[j]
        depth[j] = 0 if p < 0 else depth[p] + 1
    return tuple(np.where(depth == d)[0]
                 for d in range(int(depth.max()) + 1))


def _make_skeleton(parents, offsets) -> Skeleton:
    parents = np.asarray(parents, np.int64)
    offsets = np.asarray(offsets, np.float32).reshape(-1, 3)
    j = len(parents)
    expmap_ind = 3 + 3 * np.arange(j)
    return Skeleton(parents, offsets, expmap_ind, _levels(parents))


def h36m_skeleton() -> Skeleton:
    """32-joint H3.6M kinematic tree (tables from reference
    ``_some_variables``, utils.py:1147-1335; offsets in millimetres)."""
    parents = np.array([0, 1, 2, 3, 4, 5, 1, 7, 8, 9, 10, 1, 12, 13, 14, 15,
                        13, 17, 18, 19, 20, 21, 20, 23, 13, 25, 26, 27, 28,
                        29, 28, 31]) - 1
    offsets = np.array([
        0.0, 0.0, 0.0,
        -132.948591, 0.0, 0.0,
        0.0, -442.894612, 0.0,
        0.0, -454.206447, 0.0,
        0.0, 0.0, 162.767078,
        0.0, 0.0, 74.999437,
        132.948826, 0.0, 0.0,
        0.0, -442.894413, 0.0,
        0.0, -454.20659, 0.0,
        0.0, 0.0, 162.767426,
        0.0, 0.0, 74.999948,
        0.0, 0.1, 0.0,
        0.0, 233.383263, 0.0,
        0.0, 257.077681, 0.0,
        0.0, 121.134938, 0.0,
        0.0, 115.002227, 0.0,
        0.0, 257.077681, 0.0,
        0.0, 151.034226, 0.0,
        0.0, 278.882773, 0.0,
        0.0, 251.733451, 0.0,
        0.0, 0.0, 0.0,
        0.0, 0.0, 99.999627,
        0.0, 100.000188, 0.0,
        0.0, 0.0, 0.0,
        0.0, 257.077681, 0.0,
        0.0, 151.031437, 0.0,
        0.0, 278.892924, 0.0,
        0.0, 251.72868, 0.0,
        0.0, 0.0, 0.0,
        0.0, 0.0, 99.999888,
        0.0, 137.499922, 0.0,
        0.0, 0.0, 0.0,
    ])
    return _make_skeleton(parents, offsets)


def cmu_skeleton() -> Skeleton:
    """38-joint CMU Mocap kinematic tree (``_some_variables_cmu``,
    utils.py:1338-1559; offsets scaled by 70 as in the reference)."""
    parents = np.array([0, 1, 2, 3, 4, 5, 6, 1, 8, 9, 10, 11, 12, 1, 14, 15,
                        16, 17, 18, 19, 16, 21, 22, 23, 24, 25, 26, 24, 28,
                        16, 30, 31, 32, 33, 34, 35, 33, 37]) - 1
    offsets = 70.0 * np.array([
        0.0, 0.0, 0.0,
        0.0, 0.0, 0.0,
        1.65674, -1.80282, 0.62477,
        2.5972, -7.13576, 0.0,
        2.49236, -6.8477, 0.0,
        0.19704, -0.54136, 2.14581,
        0.0, 0.0, 1.11249,
        0.0, 0.0, 0.0,
        -1.6107, -1.80282, 0.62476,
        -2.59502, -7.12977, 0.0,
        -2.4678, -6.78024, 0.0,
        -0.23024, -0.63258, 2.13368,
        0.0, 0.0, 1.11569,
        0.0, 0.0, 0.0,
        0.01961, 2.0545, -0.14112,
        0.01021, 2.06436, -0.05921,
        0.0, 0.0, 0.0,
        0.00713, 1.56711, 0.14968,
        0.03429, 1.56041, -0.10006,
        0.01305, 1.6256, -0.05265,
        0.0, 0.0, 0.0,
        3.54205, 0.90436, -0.17364,
        4.86513, 0.0, 0.0,
        3.35554, 0.0, 0.0,
        0.0, 0.0, 0.0,
        0.66117, 0.0, 0.0,
        0.53306, 0.0, 0.0,
        0.0, 0.0, 0.0,
        0.5412, 0.0, 0.5412,
        0.0, 0.0, 0.0,
        -3.49802, 0.75994, -0.32616,
        -5.02649, 0.0, 0.0,
        -3.36431, 0.0, 0.0,
        0.0, 0.0, 0.0,
        -0.73041, 0.0, 0.0,
        -0.58887, 0.0, 0.0,
        0.0, 0.0, 0.0,
        -0.59786, 0.0, 0.59786,
    ])
    return _make_skeleton(parents, offsets)


def forward_kinematics(angles: np.ndarray, skel: Skeleton) -> np.ndarray:
    """(F, D) expmap channel vectors -> (F, J, 3) joint positions.

    Vectorized re-expression of ``fkl_torch`` (utils.py:1562-1584): level-
    synchronous accumulation down the kinematic tree.  Root-child joints
    keep local rotation/position exactly as the reference does.
    """
    f = angles.shape[0]
    j = len(skel.parents)
    r_local = expmap_to_rotmat(
        angles[:, 3:3 * (j + 1)].reshape(f, j, 3))        # (F, J, 3, 3)
    r_glob = r_local.copy()
    p3d = np.broadcast_to(skel.offsets[None], (f, j, 3)).copy()
    for level in skel.levels[1:]:
        # the reference updates only joints with parent index > 0
        lv = level[skel.parents[level] > 0]
        if lv.size == 0:
            continue
        par = skel.parents[lv]
        rp = r_glob[:, par]                               # (F, L, 3, 3)
        p3d[:, lv] = (np.einsum("lc,flcd->fld", skel.offsets[lv], rp)
                      + p3d[:, par])
        r_glob[:, lv] = np.einsum("flab,flbc->flac", r_local[:, lv], rp)
    return p3d.astype(np.float32)


def expmap_to_xyz(angles: np.ndarray, layout: str = "h36m") -> np.ndarray:
    """(F, D) expmap -> (F, J, 3); layout in {h36m, cmu}."""
    skel = h36m_skeleton() if layout == "h36m" else cmu_skeleton()
    return forward_kinematics(np.asarray(angles, np.float32), skel)
