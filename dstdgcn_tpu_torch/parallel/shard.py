"""Edge-partitioned DSTD-GC: the joint axis split over the mesh's ``graph``
group, with explicit collectives.

Counterpart of ``dstdgcn_tpu/parallel/shard.py``, whose ``shard_map``
bodies these functions are: each takes this rank's joint slice ``x_local``
(joints ``i * V_loc .. (i + 1) * V_loc`` of ``x``, ``i`` the rank's index
along ``graph``) and the replicated weights, and returns the rank's slice
of the output.  The JAX package computes them with plain einsums outside
Pallas, and so do these (``torch.einsum``).  Gradients flow through the
collectives (:mod:`.collectives`: all-gather ↔ reduce-scatter, send ↔
receive); a replicated weight's gradient on a rank is that rank's share,
and the sum over the ranks is the weight's gradient.

* :func:`dstd_spatial_edge_partitioned`: the correlation keys (a small
  ``(K, N, T, V_loc, R)`` tensor) are all-gathered, each rank computes the
  scores, dynamic adjacency and aggregation of its source joints against
  every destination joint, and a reduce-scatter over destination joints
  sums the partials back onto the joint slices;
* :func:`dstd_temporal_edge_partitioned`: the scores are joint-local; the
  ``wrm`` joint mixing is reduce-scattered over output joints;
* :func:`dstd_spatial_ring`: ``n`` rounds around the ring.  Round ``r``
  posts the send of its (query, feature) chunk to the next rank and the
  receive of the previous rank's before its own score, mix and aggregate
  compute, and waits only at the round's end, so the transfer runs under
  the compute; every (source, destination) pair is visited once.
"""

from __future__ import annotations

import torch

from .collectives import RingShift, all_gather, reduce_scatter
from .mesh import Mesh

__all__ = ["dstd_spatial_edge_partitioned", "dstd_temporal_edge_partitioned",
           "dstd_spatial_ring"]

AXIS = "graph"


def _local_project(x, w, b):
    """(N,T,V,Ci) x (K,Ci,Co) -> (K,N,T,V,Co)."""
    return torch.einsum("ntvc,kcd->kntvd", x, w) + b[:, None, None, None, :]


def _slice(mesh: Mesh, x_local):
    """(group, number of ranks, this rank's index, V_loc) of the graph
    axis."""
    return (mesh.group(AXIS), mesh.shape[AXIS], mesh.index(AXIS),
            x_local.shape[2])


def dstd_spatial_edge_partitioned(mesh: Mesh, x_local, base_adj, alpha,
                                  wf, bf, wm1, bm1, wm2, bm2, wrm, brm):
    """Spatial DSTD-GC on this rank's joint slice: x_local (N, T, V_loc, Ci)
    -> (N, T, V_loc, Co), ``V = n * V_loc``."""
    group, _, idx, v_loc = _slice(mesh, x_local)
    q = _local_project(x_local, wm1, bm1)             # (K,N,T,V_loc,R)
    k = _local_project(x_local, wm2, bm2)
    # the destination-side keys of every rank (a small tensor)
    k_full = all_gather(k, 3, group)                  # (K,N,T,V,R)
    s = torch.tanh(q[..., :, None, :] - k_full[..., None, :, :])
    s = torch.movedim(s, -1, -3)                      # (K,N,T,R,V_loc,V)
    dyn = torch.einsum("knsrvw,krst->kntvw", s, wrm) \
        + brm[:, None, :, None, None]
    base_rows = base_adj[:, idx * v_loc:(idx + 1) * v_loc]   # (K,V_loc,V)
    adj = dyn * alpha + base_rows[:, None, None, :, :]
    xf = _local_project(x_local, wf, bf)              # (K,N,T,V_loc,Co)
    # the local sources' partial aggregation, for every destination
    part = torch.einsum("kntvc,kntvw->ntwc", xf, adj)  # (N,T,V,Co)
    return reduce_scatter(part, 2, group)


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
    group, n, idx, v_loc = _slice(mesh, x_local)
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
                                   wf, bf, wm1, bm1, wm2, bm2, wrm, brm):
    """Temporal DSTD-GC on this rank's joint slice: the pairwise frame
    scores are joint-local, and the ``wrm`` joint mixing is the one
    reduction across ranks.  x_local (N, T, V_loc, Ci) -> (N, T, V_loc,
    Co)."""
    group, _, idx, v_loc = _slice(mesh, x_local)
    q = _local_project(x_local, wm1, bm1)             # (K,N,T,V_loc,R)
    k = _local_project(x_local, wm2, bm2)
    qt, kt = q.transpose(2, 3), k.transpose(2, 3)     # (K,N,V_loc,T,R)
    s = torch.tanh(qt[..., :, None, :] - kt[..., None, :, :])
    s = torch.movedim(s, -1, -3)                      # (K,N,V_loc,R,T,T)
    # the local source joints mix into every output joint
    wrm_rows = wrm[:, :, idx * v_loc:(idx + 1) * v_loc]     # (K,R,V_loc,V)
    part = torch.einsum("knvrtu,krvw->knwtu", s, wrm_rows)  # (K,N,V,T,T)
    dyn = reduce_scatter(part, 2, group)              # (K,N,V_loc,T,T)
    brm_loc = brm[:, idx * v_loc:(idx + 1) * v_loc]
    dyn = dyn + brm_loc[:, None, :, None, None]
    adj = dyn * alpha + base_adj[:, None, None, :, :]
    xf = _local_project(x_local, wf, bf)              # (K,N,T,V_loc,Co)
    # the per-joint temporal aggregation, local
    return torch.einsum("kntvc,knvtu->nuvc", xf, adj)
