"""Road-sensor graphs for traffic forecasting (numpy).

A loop-detector network is drawn from a seed the way DCRNN and LargeST
build theirs from road distances: sensors lie along freeways, the directed
road distance of two sensors is their straight-line distance lengthened by
a detour of each direction, and the adjacency is the thresholded Gaussian
kernel of the distances, ``W_ij = exp(-(d_ij / sigma)^2)`` kept where it is
at least ``kappa`` (0.1), ``sigma`` the standard deviation of the listed
distances.  A pair is listed when the sensors lie within ``reach_km`` of
each other, and every sensor is listed with itself at distance 0, so the
adjacency has ones on its diagonal.  The sensors come in a shuffled order,
as sensor IDs do.

For the blocked SpMM the module also gives:

* the two transition matrices of Graph WaveNet's ``doubletransition``
  supports: ``P_f = D_out^-1 A`` and ``P_b = D_in^-1 A^T``
  (:func:`transitions`);
* a bandwidth-reducing node order, reverse Cuthill-McKee on the
  symmetrised pattern (:func:`rcm_order`), which gathers the edges near the
  diagonal, into few ``block x block`` blocks;
* the block list of a matrix in that order, padded to a multiple of the
  block (:func:`block_list`).
"""

from __future__ import annotations

from collections import deque
from typing import Tuple

import numpy as np

__all__ = ["road_graph", "transitions", "rcm_order", "inverse_order",
           "block_list", "padded", "KAPPA"]

#: the Gaussian kernel's threshold (DCRNN's ``normalized_k``)
KAPPA = 0.1


def _positions(rng: np.random.Generator, v: int, freeways: int,
               extent_km: float) -> np.ndarray:
    """(v, 2) sensor positions in km: each sensor on one of ``freeways``
    straight freeways across a square of side ``extent_km``, with a lane's
    jitter."""
    start = rng.uniform(0, extent_km, (freeways, 2))
    angle = rng.uniform(0, np.pi, freeways)
    length = rng.uniform(0.3, 0.9, freeways) * extent_km
    way = rng.integers(0, freeways, v)
    along = rng.uniform(0, 1, v) * length[way]
    pos = start[way] + along[:, None] * np.stack(
        [np.cos(angle[way]), np.sin(angle[way])], 1)
    return pos + rng.normal(0, 0.05, (v, 2))


def road_graph(v: int, seed: int, freeways: int = 40,
               extent_km: float = 80.0, reach_km: float = 7.5,
               kappa: float = KAPPA) -> np.ndarray:
    """(v, v) float32 weighted adjacency of ``v`` sensors drawn from
    ``seed``, in the shuffled sensor order: ``W[i, j]`` weighs the road
    from sensor i to sensor j."""
    rng = np.random.default_rng([int(seed), 11])
    pos = _positions(rng, v, freeways, extent_km)
    pos = pos[rng.permutation(v)]
    euclid = np.sqrt(((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1))
    # each direction its own detour: the road distance is asymmetric
    road = euclid * (1.0 + rng.uniform(0.0, 0.4, (v, v)))
    listed = euclid <= reach_km
    np.fill_diagonal(road, 0.0)
    sigma = road[listed].std()
    w = np.where(listed, np.exp(-np.square(road / sigma)), 0.0)
    w[w < kappa] = 0.0
    return w.astype(np.float32)


def _row_normalised(a: np.ndarray) -> np.ndarray:
    """``D^-1 a`` with ``D`` the row sums (a zero row stays zero)."""
    d = a.sum(1, dtype=np.float64)
    inv = np.divide(1.0, d, out=np.zeros_like(d), where=d != 0)
    return (inv[:, None] * a).astype(np.float32)


def transitions(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Graph WaveNet's ``doubletransition`` supports of ``adj``: the
    forward ``D_out^-1 A`` and the backward ``D_in^-1 A^T``."""
    adj = np.asarray(adj, np.float32)
    return _row_normalised(adj), _row_normalised(adj.T)


def rcm_order(adj: np.ndarray) -> np.ndarray:
    """A reverse Cuthill-McKee order of the nodes of ``adj`` (the pattern
    made symmetric): ``order[k]`` is the node placed at position k.  Each
    connected component starts from a pseudo-peripheral node (the far end
    of a breadth-first sweep from its node of least degree); neighbours
    are visited by rising degree."""
    pat = (np.asarray(adj) != 0)
    pat = pat | pat.T
    np.fill_diagonal(pat, False)
    v = pat.shape[0]
    nbrs = [np.flatnonzero(pat[i]) for i in range(v)]
    degree = pat.sum(1)
    for i in range(v):
        nbrs[i] = nbrs[i][np.argsort(degree[nbrs[i]], kind="stable")]

    def sweep(root, seen):
        order, queue = [root], deque([root])
        seen[root] = True
        while queue:
            for j in nbrs[queue.popleft()]:
                if not seen[j]:
                    seen[j] = True
                    order.append(j)
                    queue.append(j)
        return order

    done = np.zeros(v, bool)
    out = []
    for root in np.argsort(degree, kind="stable"):
        if done[root]:
            continue
        far = sweep(root, done.copy())[-1]
        out += sweep(far, done)
    return np.asarray(out[::-1], np.int64)


def inverse_order(order: np.ndarray) -> np.ndarray:
    """The positions of the nodes in ``order``: ``inv[order[k]] = k``."""
    inv = np.empty(len(order), np.int64)
    inv[np.asarray(order)] = np.arange(len(order))
    return inv


def padded(v: int, block: int) -> int:
    """``v`` rounded up to a multiple of ``block``."""
    return -(-v // block) * block


def block_list(m: np.ndarray, block: int) -> Tuple[np.ndarray, np.ndarray]:
    """(rows, cols) int32 row-major list of the ``block x block`` blocks of
    ``m`` (zero-padded to a multiple of ``block``) that hold a nonzero;
    a block row with none gets its diagonal block, as
    ``kernels/sparse.py::active_blocks`` gives it."""
    v, vj = m.shape
    bi, bj = padded(v, block) // block, padded(vj, block) // block
    nz = np.zeros((bi * block, bj * block), bool)
    nz[:v, :vj] = np.asarray(m) != 0
    mask = nz.reshape(bi, block, bj, block).any(axis=(1, 3))
    for i in range(bi):
        if not mask[i].any():
            mask[i, min(i, bj - 1)] = True
    rows, cols = np.nonzero(mask)
    return rows.astype(np.int32), cols.astype(np.int32)
