"""Edge-partitioned DSTD-GC: the joint axis split over the mesh's ``graph``
group, with explicit collectives.

Counterpart of ``dstdgcn_tpu/parallel/shard.py``, whose ``shard_map``
bodies these functions are: each takes this rank's joint slice ``x_local``
(joints ``mesh.joints(V)`` of ``x``: blocks of ``ceil(V / n)``, the last
ones shorter, as GSPMD splits V = 25 over 2) and the replicated weights,
and returns the rank's slice of the output.  The JAX package computes them
with plain einsums outside Pallas, and so do these (``torch.einsum``).
Gradients flow through the collectives (:mod:`.collectives`: all-gather ↔
reduce-scatter, send ↔ receive); a replicated weight's gradient on a rank
is that rank's share, and the sum over the ranks is the weight's gradient.

The two edge-partitioned ops take ``agg``: ``"right"`` (the qualitative
model, the JAX module's only form) or ``"left"`` (the fast variant,
``ops/dstd.py::aggregate_spatial`` / ``aggregate_temporal``):

* :func:`dstd_spatial_edge_partitioned`: the correlation keys (a small
  ``(K, N, T, V_loc, R)`` tensor) are all-gathered and each rank computes
  the scores and dynamic adjacency of its own rows (query joints) against
  every joint.  Right: a rank's rows are source joints; it aggregates them
  into every destination joint and a reduce-scatter over destination joints
  sums the partials back onto the joint slices.  Left: a rank's rows are
  destination joints; it all-gathers the feature projection too and
  aggregates every source into its rows, no reduce-scatter;
* :func:`dstd_temporal_edge_partitioned`: the scores are joint-local; the
  ``wrm`` joint mixing is reduce-scattered over output joints; the
  aggregation over frames is joint-local in both forms;
* :func:`dstd_spatial_ring` (right, an even split): ``n`` rounds around the
  ring.  Round ``r`` posts the send of its (query, feature) chunk to the
  next rank and the receive of the previous rank's before its own score,
  mix and aggregate compute, and waits only at the round's end, so the
  transfer runs under the compute; every (source, destination) pair is
  visited once.
"""

from __future__ import annotations

import torch

from .collectives import RingShift, gather_blocks, scatter_blocks
from .mesh import Mesh

__all__ = ["dstd_spatial_edge_partitioned", "dstd_temporal_edge_partitioned",
           "dstd_spatial_ring"]

AXIS = "graph"


def _local_project(x, w, b):
    """(N,T,V,Ci) x (K,Ci,Co) -> (K,N,T,V,Co)."""
    return torch.einsum("ntvc,kcd->kntvd", x, w) + b[:, None, None, None, :]


def _graph(mesh: Mesh, v: int):
    """(group, number of ranks, this rank's joint range) of the graph axis
    over ``v`` joints."""
    n = mesh.shape[AXIS]
    return mesh.group(AXIS), n, mesh.joints(v)


def _check_agg(agg: str) -> None:
    if agg not in ("right", "left"):
        raise ValueError(f"agg={agg!r}: expected 'right' or 'left'")


def dstd_spatial_edge_partitioned(mesh: Mesh, x_local, base_adj, alpha,
                                  wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                                  agg: str = "right"):
    """Spatial DSTD-GC on this rank's joint slice: x_local (N, T, V_loc, Ci)
    -> (N, T, V_loc, Co), V = ``base_adj.shape[-1]``."""
    _check_agg(agg)
    v = base_adj.shape[-1]
    group, _, rows = _graph(mesh, v)
    q = _local_project(x_local, wm1, bm1)             # (K,N,T,V_loc,R)
    k = _local_project(x_local, wm2, bm2)
    # every joint's keys (a small tensor)
    k_full = gather_blocks(k, 3, group, v)            # (K,N,T,V,R)
    s = torch.tanh(q[..., :, None, :] - k_full[..., None, :, :])
    s = torch.movedim(s, -1, -3)                      # (K,N,T,R,V_loc,V)
    dyn = torch.einsum("knsrvw,krst->kntvw", s, wrm) \
        + brm[:, None, :, None, None]
    adj = dyn * alpha + base_adj[:, rows][:, None, None]   # (K,N,T,V_loc,V)
    xf = _local_project(x_local, wf, bf)              # (K,N,T,V_loc,Co)
    if agg == "right":
        # the local sources' partial aggregation, for every destination
        part = torch.einsum("kntvc,kntvw->ntwc", xf, adj)  # (N,T,V,Co)
        return scatter_blocks(part, 2, group)
    # the local destinations aggregate every source's features
    xf_full = gather_blocks(xf, 3, group, v)          # (K,N,T,V,Co)
    return torch.einsum("kntvw,kntwc->ntvc", adj, xf_full)


def _ring_round(q_chunk, xf_chunk, k_loc, rows, alpha, wrm, brm):
    """One round of the ring: the scores, dynamic adjacency and aggregation
    of one source chunk against this rank's destinations."""
    s = torch.tanh(q_chunk[..., :, None, :]
                   - k_loc[..., None, :, :])          # (K,N,T,Vc,Vl,R)
    s = torch.movedim(s, -1, -3)                      # (K,N,T,R,Vc,Vl)
    dyn = torch.einsum("knsrvw,krst->kntvw", s, wrm) \
        + brm[:, None, :, None, None]
    adj = dyn * alpha + rows[:, None, None, :, :]
    return torch.einsum("kntvc,kntvw->ntwc", xf_chunk, adj)


def dstd_spatial_ring(mesh: Mesh, x_local, base_adj, alpha,
                      wf, bf, wm1, bm1, wm2, bm2, wrm, brm):
    """Ring-pipelined spatial DSTD-GC on this rank's joint slice (the same
    function as :func:`dstd_spatial_edge_partitioned`).

    Each rank owns its destination joints and adds one source chunk a
    round: round ``r`` computes the chunk of rank ``(i - r) mod n`` while the
    shift posted at the round's start carries that chunk on to the next
    rank.  What is sent is the chunk the round received (or, in round 0,
    the rank's own projections), never a round's result.
    """
    group, n, _ = _graph(mesh, base_adj.shape[-1])
    idx, v_loc = mesh.index(AXIS), x_local.shape[2]
    if v_loc * n != base_adj.shape[-1]:
        raise ValueError(f"dstd_spatial_ring: {base_adj.shape[-1]} joints "
                         f"do not split evenly over {n} ranks")
    # keys stay put (destination side); queries and features travel
    k_loc = _local_project(x_local, wm2, bm2)         # (K,N,T,V_loc,R)
    q_chunk = _local_project(x_local, wm1, bm1)
    xf_chunk = _local_project(x_local, wf, bf)        # (K,N,T,V_loc,Co)
    base_cols = base_adj[:, :, idx * v_loc:(idx + 1) * v_loc]   # (K,V,V_loc)
    ring = RingShift(group) if n > 1 else None
    out = None
    for r in range(n):
        received = ring.post(q_chunk, xf_chunk) if r + 1 < n else None
        src = (idx - r) % n
        rows = base_cols[:, src * v_loc:(src + 1) * v_loc]      # (K,Vc,Vl)
        part = _ring_round(q_chunk, xf_chunk, k_loc, rows, alpha, wrm, brm)
        out = part if out is None else out + part
        if received is not None:
            q_chunk, xf_chunk = ring.wait(received)
    return out


def dstd_temporal_edge_partitioned(mesh: Mesh, x_local, base_adj, alpha,
                                   wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                                   agg: str = "right"):
    """Temporal DSTD-GC on this rank's joint slice: the pairwise frame
    scores are joint-local, and the ``wrm`` joint mixing is the one
    reduction across ranks.  x_local (N, T, V_loc, Ci) -> (N, T, V_loc,
    Co), V = ``wrm.shape[-1]``."""
    _check_agg(agg)
    group, _, rows = _graph(mesh, wrm.shape[-1])
    q = _local_project(x_local, wm1, bm1)             # (K,N,T,V_loc,R)
    k = _local_project(x_local, wm2, bm2)
    qt, kt = q.transpose(2, 3), k.transpose(2, 3)     # (K,N,V_loc,T,R)
    s = torch.tanh(qt[..., :, None, :] - kt[..., None, :, :])
    s = torch.movedim(s, -1, -3)                      # (K,N,V_loc,R,T,T)
    # the local source joints mix into every output joint
    part = torch.einsum("knvrtu,krvw->knwtu", s,
                        wrm[:, :, rows])              # (K,N,V,T,T)
    dyn = scatter_blocks(part, 2, group)              # (K,N,V_loc,T,T)
    dyn = dyn + brm[:, rows][:, None, :, None, None]
    adj = dyn * alpha + base_adj[:, None, None, :, :]
    xf = _local_project(x_local, wf, bf)              # (K,N,T,V_loc,Co)
    # the per-joint temporal aggregation, local
    if agg == "right":
        return torch.einsum("kntvc,knvtu->nuvc", xf, adj)
    return torch.einsum("knvtu,knuvc->ntvc", adj, xf)
