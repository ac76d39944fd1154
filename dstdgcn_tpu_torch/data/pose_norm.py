"""Rigid frame-normalization of pose sequences (ExPI / NTU-RGBD).

Counterpart of ``dstdgcn_tpu/data/pose_norm.py`` in numpy, the same
operations in the same order.

Capability parity with the reference helpers ``normExPI_xoz`` /
``normExPI_2p_by_frame`` / ``normNTURGBD_*`` / ``filter_frames``
(``dataset/utils.py:2272-2421``): each frame is mapped into a canonical
body-centric coordinate system — origin at an anchor joint, x toward a
second anchor, the xoz plane through a third — via a per-frame affine
solved from four constructed points.  The reference loops python-level over
frames and joints; here the whole sequence is one batched ``pinv`` +
einsum.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = [
    "rigid_frame_matrix",
    "rigid_frame_normalize",
    "normalize_expi_2p",
    "normalize_expi_independent",
    "normalize_ntu",
    "normalize_ntu_independent",
    "ntu_pelvis_center",
    "filter_zero_frames",
]

_EPS = 1e-10

# canonical targets of the four constructed points (origin, x, z, y)
_Q = np.array([[0.0, 0.0, 0.0],
               [1.0, 0.0, 0.0],
               [0.0, 0.0, 1.0],
               [0.0, 1.0, 0.0]], dtype=np.float64).T  # (3, 4)


def rigid_frame_matrix(p0: np.ndarray, p1: np.ndarray,
                       p2: np.ndarray) -> np.ndarray:
    """Per-frame affine (..., 3, 4) sending (p0, x-dir, xoz-plane) to the
    canonical frame (reference normExPI_xoz, utils.py:2272-2293).

    ``p0`` origin, ``p0->p1`` the x axis, ``p2`` fixing the xoz plane; all
    (..., 3) and broadcast over leading dims.
    """
    x1 = (p1 - p0) / (np.linalg.norm(p1 - p0, axis=-1, keepdims=True) + _EPS)
    x2 = (p2 - p0) / (np.linalg.norm(p2 - p0, axis=-1, keepdims=True) + _EPS)
    x3 = np.cross(x2, x1)                       # y direction
    x2 = np.cross(x1, x3)                       # re-orthogonalized z
    pts = np.stack([p0, x1 + p0, x2 + p0, x3 + p0], axis=-2)  # (..., 4, 3)
    x_h = np.concatenate(
        [np.swapaxes(pts, -1, -2),
         np.ones(pts.shape[:-2] + (1, 4), pts.dtype)], axis=-2)  # (...,4,4)
    return _Q @ np.linalg.pinv(x_h)             # (..., 3, 4)


def rigid_frame_normalize(points: np.ndarray, anchors: Tuple[int, int, int],
                          ) -> np.ndarray:
    """Normalize (..., J, 3) joint positions frame-by-frame.

    ``anchors`` are (origin, x, plane) joint indices; an anchor of -1 for
    the origin means "midpoint of x-anchor and the joint before it" is NOT
    supported here — pass precomputed anchor points via
    :func:`rigid_frame_matrix` for exotic origins.
    """
    a0, a1, a2 = anchors
    m = rigid_frame_matrix(points[..., a0, :], points[..., a1, :],
                           points[..., a2, :])
    return apply_affine(m, points)


def apply_affine(m: np.ndarray, points: np.ndarray) -> np.ndarray:
    """(..., 3, 4) affine applied to (..., J, 3) points."""
    return (np.einsum("...ij,...vj->...vi", m[..., :3], points)
            + m[..., None, :, 3]).astype(points.dtype)


# -- ExPI (36 joints = 2 x 18; anchors hip-mid / right hip / back) ----------

def _expi_anchors(img: np.ndarray, off: int = 0):
    p0 = (img[..., off + 10, :] + img[..., off + 11, :]) / 2
    return p0, img[..., off + 11, :], img[..., off + 3, :]


def normalize_expi_2p(seq: np.ndarray) -> np.ndarray:
    """(F, 108) two-person flat sequence, whole frame normalized by person
    1's anchors (reference normExPI_2p_by_frame, utils.py:2296-2306)."""
    f, dim = seq.shape
    img = seq.reshape(f, dim // 3, 3)
    m = rigid_frame_matrix(*_expi_anchors(img))
    return apply_affine(m, img).reshape(f, dim)


def normalize_expi_independent(seq: np.ndarray) -> np.ndarray:
    """(B, F, J, 3) with J in {18, 36}: each person normalized by their own
    anchors (reference unnorm_abs2Indep, utils.py:2309-2332)."""
    j = seq.shape[-2]
    if j == 18:
        m = rigid_frame_matrix(*_expi_anchors(seq))
        return apply_affine(m, seq)
    if j != 36:
        raise ValueError(f"expected 18 or 36 joints, got {j}")
    first = apply_affine(rigid_frame_matrix(*_expi_anchors(seq)),
                         seq[..., :18, :])
    second = apply_affine(rigid_frame_matrix(*_expi_anchors(seq, 18)),
                          seq[..., 18:, :])
    return np.concatenate([first, second], axis=-2)


# -- NTU-RGBD (25/50 joints; anchors pelvis / right hip / spine) -------------

def normalize_ntu(seq: np.ndarray) -> np.ndarray:
    """(F, 150) two-person flat NTU sequence, pelvis-centered then whole
    frame normalized by person 1 (reference normNTURGBD_2p_by_frame,
    utils.py:2363-2376)."""
    f, dim = seq.shape
    img = seq.reshape(f, dim // 3, 3)
    img = img - img[:, :1]
    m = rigid_frame_matrix(img[:, 0], img[:, 16], img[:, 20])
    return apply_affine(m, img).reshape(f, dim)


def normalize_ntu_independent(seq: np.ndarray) -> np.ndarray:
    """(B, F, J, 3) with J in {25, 50}: per-person normalization (reference
    unnormNTURGBD_abs2Indep, utils.py:2379-2406)."""
    j = seq.shape[-2]
    if j == 25:
        m = rigid_frame_matrix(seq[..., 0, :], seq[..., 16, :],
                               seq[..., 20, :])
        return apply_affine(m, seq)
    if j != 50:
        raise ValueError(f"expected 25 or 50 joints, got {j}")
    first = apply_affine(
        rigid_frame_matrix(seq[..., 0, :], seq[..., 16, :], seq[..., 20, :]),
        seq[..., :25, :])
    p0 = (seq[..., 25 + 12, :] + seq[..., 25 + 16, :]) / 2
    second = apply_affine(
        rigid_frame_matrix(p0, seq[..., 25 + 16, :], seq[..., 25 + 20, :]),
        seq[..., 25:, :])
    return np.concatenate([first, second], axis=-2)


def ntu_pelvis_center(seq: np.ndarray) -> np.ndarray:
    """(F, D) -> (F, D//3, 3) centered on frame 0's pelvis (reference
    normNTURGBD_pelvis, utils.py:2409-2412)."""
    f, dim = seq.shape
    pts = seq.reshape(f, dim // 3, 3)
    return pts - pts[:1, :1]


def filter_zero_frames(seq: np.ndarray) -> np.ndarray:
    """Drop all-zero frames (reference filter_frames, utils.py:2415-2421)."""
    keep = ~np.all(seq.reshape(seq.shape[0], -1) == 0, axis=1)
    return seq[keep]
