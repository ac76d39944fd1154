"""Functional DSTD-GC operators in plain PyTorch.

Counterpart of ``dstdgcn_tpu/ops/dstd.py`` (the JAX package's XLA path) and
the plain version of both CUDA kernels in :mod:`..kernels.fused`: the CPU
tests hold these functions against the JAX package, and ``chip_smoke.py``
holds each kernel against them on the card.

Shapes are channels-last ``(N, T, V, C)``.  N batch, T frames, V joints,
C channels, R reduction channels (2), K stacked graph kernels (2 spatial,
1 temporal).  Weights:

  wf  (K, C_in, C_out), bf (K, C_out)        feature transform
  wm1 (K, C_in, R),     bm1 (K, R)           correlation query projection
  wm2 (K, C_in, R),     bm2 (K, R)           correlation key projection
  wrm spatial  (K, R, T, T),  brm (K, T)     frame mixing of pair scores
  wrm temporal (K, R, V, V),  brm (K, V)     joint mixing of pair scores

``dtype`` (e.g. ``torch.bfloat16``) rounds the inputs of every contraction
to that type while the products and sums stay float32, and the op emits
``dtype``; ``None`` is plain float32.  These are the rounding points of the
JAX package's XLA path (q/k and the adjacency are computed in ``dtype``).
The fused kernels round elsewhere: :func:`kernel_spatial` and
:func:`kernel_temporal` are the plain version of the kernels' contract
(``dstdgcn_tpu/kernels/fused.py::_spatial_kernel`` / ``_temporal_kernel``
with a ``dtype``), which rounds only the operands of the four contractions
``x wqk``, ``x wf``, ``s wrm`` and ``adj xf``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "sddmm_pairwise_tanh",
    "dyn_adjacency_spatial",
    "dyn_adjacency_temporal",
    "aggregate_spatial",
    "aggregate_temporal",
    "dstd_spatial",
    "dstd_temporal",
    "kernel_spatial",
    "kernel_temporal",
]


def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype is None else x.to(dtype)


def _dot_in(x: torch.Tensor, dtype) -> torch.Tensor:
    """Contraction input: rounded to ``dtype``, computed in float32 (a
    product of two bf16 values is exact in float32), or in float64 for a
    float64 input (a float64 reference of the same rounding)."""
    if dtype is None:
        return x
    return x.to(dtype).to(torch.promote_types(x.dtype, torch.float32))


def _project(x, w, b, dtype=None) -> torch.Tensor:
    """(N,T,V,Ci) x (K,Ci,Co) -> (K,N,T,V,Co)."""
    y = torch.einsum("ntvc,kcd->kntvd", _dot_in(x, dtype), _dot_in(w, dtype))
    return y + b[:, None, None, None, :]


def sddmm_pairwise_tanh(q: torch.Tensor, k: torch.Tensor,
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All-pairs constrained-correlation scores ``tanh(q_i - k_j)``.

    q, k: (..., P, R) over P nodes -> (..., R, P, P) scores; the optional
    0/1 ``mask`` (P, P) keeps only permitted pairs.
    """
    s = torch.tanh(q[..., :, None, :] - k[..., None, :, :])   # (..., P, P, R)
    if mask is not None:
        s = s * mask[..., :, :, None]
    return torch.movedim(s, -1, -3)                           # (..., R, P, P)


def _qk(x, wm1, bm1, wm2, bm2, layout: str, dtype):
    """Both correlation projections in one contraction -> (q, k), each
    (K, N, R, A, B) with ``layout`` naming (A, B) over frames/joints."""
    rr = wm1.shape[-1]
    qk = torch.einsum(f"ntvc,kcr->kn{layout}", _dot_in(x, dtype),
                      _dot_in(torch.cat([wm1, wm2], dim=-1), dtype)) \
        + torch.cat([bm1, bm2], dim=-1)[:, None, :, None, None]
    return _cast(qk[:, :, :rr], dtype), _cast(qk[:, :, rr:], dtype)


def dyn_adjacency_spatial(x, wm1, bm1, wm2, bm2, wrm, brm, mask=None,
                          dtype=None) -> torch.Tensor:
    """Dynamic per-frame joint adjacency, x (N,T,V,C) -> (K,N,T,V,V): project
    to R channels, all-pairs tanh difference over joints, then mix the
    (R, source frame) score channels into each output frame with ``wrm``."""
    kk, rr = wm1.shape[0], wm1.shape[-1]
    nn, tt, vv = x.shape[0], x.shape[1], x.shape[2]
    q, k = _qk(x, wm1, bm1, wm2, bm2, "rtv", dtype)
    q = q.reshape(kk, nn, rr * tt, vv)
    k = k.reshape(kk, nn, rr * tt, vv)
    s = torch.tanh(q[..., :, None] - k[..., None, :])         # (K,N,R*T,V,W)
    if mask is not None:
        s = s * mask
    dyn = torch.einsum("knsvw,kst->kntvw", _dot_in(s, dtype),
                       _dot_in(wrm.reshape(kk, rr * tt, tt), dtype))
    return dyn + brm[:, None, :, None, None]


def dyn_adjacency_temporal(x, wm1, bm1, wm2, bm2, wrm, brm, mask=None,
                           dtype=None) -> torch.Tensor:
    """Dynamic per-joint frame adjacency, x (N,T,V,C) -> (K,N,V,T,T): the
    pairwise tanh over frames, mixing the (R, source joint) score channels
    into each output joint."""
    kk, rr = wm1.shape[0], wm1.shape[-1]
    nn, tt, vv = x.shape[0], x.shape[1], x.shape[2]
    q, k = _qk(x, wm1, bm1, wm2, bm2, "rvt", dtype)
    q = q.reshape(kk, nn, rr * vv, tt)
    k = k.reshape(kk, nn, rr * vv, tt)
    s = torch.tanh(q[..., :, None] - k[..., None, :])         # (K,N,R*V,T,U)
    if mask is not None:
        s = s * mask
    dyn = torch.einsum("knstu,ksw->knwtu", _dot_in(s, dtype),
                       _dot_in(wrm.reshape(kk, rr * vv, vv), dtype))
    return dyn + brm[:, None, :, None, None]


def aggregate_spatial(xf, adj, agg: str = "right", dtype=None):
    """Per-frame dense SpMM over joints, summed over stacked kernels.

    xf (K,N,T,V,C), adj (K,N,T,V,V) -> (N,T,V,C).  ``right`` (qualitative):
    out[n,t,w,c] = sum_{k,v} xf[k,n,t,v,c] adj[k,n,t,v,w]; ``left`` (fast):
    out[n,t,v,c] = sum_{k,w} adj[k,n,t,v,w] xf[k,n,t,w,c].
    """
    xf, adj = _dot_in(xf, dtype), _dot_in(adj, dtype)
    if agg == "right":
        return torch.einsum("kntvc,kntvw->ntwc", xf, adj)
    return torch.einsum("kntvw,kntwc->ntvc", adj, xf)


def aggregate_temporal(xf, adj, agg: str = "right", dtype=None):
    """Per-joint dense SpMM over frames, summed over stacked kernels.

    xf (K,N,T,V,C), adj (K,N,V,T,T) -> (N,T,V,C).  ``right``:
    out[n,u,v,c] = sum_{k,t} xf[k,n,t,v,c] adj[k,n,v,t,u]; ``left``:
    out[n,t,v,c] = sum_{k,u} adj[k,n,v,t,u] xf[k,n,u,v,c].
    """
    xf, adj = _dot_in(xf, dtype), _dot_in(adj, dtype)
    if agg == "right":
        return torch.einsum("kntvc,knvtu->nuvc", xf, adj)
    return torch.einsum("knvtu,knuvc->ntvc", adj, xf)


def _check_agg(agg: str) -> None:
    if agg not in ("right", "left"):
        raise ValueError(f"agg={agg!r}: expected 'right' or 'left'")


def dstd_spatial(x, base_adj, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                 mask=None, agg: str = "right", dtype=None,
                 pair_flat: bool = False, agg_group=None) -> torch.Tensor:
    """Full spatial DSTD-GC over K stacked kernels.

    x (N,T,V,Ci), base_adj (K,V,V) static part -> (N,T,V,Co); the effective
    adjacency is ``dyn * alpha + base``.  ``pair_flat`` and ``agg_group``
    are layout choices of the JAX package with the same result; they are
    accepted and change nothing here.
    """
    del pair_flat, agg_group
    _check_agg(agg)
    alpha = torch.as_tensor(alpha, device=x.device,
                            dtype=torch.promote_types(x.dtype, torch.float32))
    xf = _cast(_project(x, wf, bf, dtype), dtype)             # (K,N,T,V,Co)
    dyn = dyn_adjacency_spatial(x, wm1, bm1, wm2, bm2, wrm, brm, mask, dtype)
    adj = _cast(dyn, dtype) * _cast(alpha, dtype) \
        + _cast(base_adj, dtype)[:, None, None, :, :]
    out = aggregate_spatial(xf, adj, agg, dtype)
    return out if dtype is None else out.to(dtype)


def dstd_temporal(x, base_adj, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                  mask=None, agg: str = "right", dtype=None,
                  pair_flat: bool = False, agg_group=None) -> torch.Tensor:
    """Full temporal DSTD-GC over K stacked kernels.

    x (N,T,V,Ci), base_adj (K,T,T) static part -> (N,T,V,Co).
    ``pair_flat`` / ``agg_group`` as in :func:`dstd_spatial`.
    """
    del pair_flat, agg_group
    _check_agg(agg)
    alpha = torch.as_tensor(alpha, device=x.device,
                            dtype=torch.promote_types(x.dtype, torch.float32))
    xf = _cast(_project(x, wf, bf, dtype), dtype)             # (K,N,T,V,Co)
    dyn = dyn_adjacency_temporal(x, wm1, bm1, wm2, bm2, wrm, brm, mask, dtype)
    adj = _cast(dyn, dtype) * _cast(alpha, dtype) \
        + _cast(base_adj, dtype)[:, None, None, :, :]
    out = aggregate_temporal(xf, adj, agg, dtype)
    return out if dtype is None else out.to(dtype)


def _wide(x, w) -> torch.dtype:
    """The arithmetic type of a kernel-form op: float32 for a float32 or
    bf16 activation and float32 weights, float64 for float64 weights."""
    return torch.promote_types(torch.promote_types(x.dtype, w.dtype),
                               torch.float32)


def _kernel_op(mode, x, base_adj, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm,
               brm, agg, dtype):
    _check_agg(agg)
    x = x.to(_wide(x, wf))
    a = torch.as_tensor(alpha, dtype=x.dtype, device=x.device).reshape(())
    layout = "rtv" if mode == "spatial" else "rvt"   # q/k (K,N,R,S,P)
    xr = _dot_in(x, dtype)
    xf = _project(x, wf, bf, dtype)                           # (K,N,T,V,Co)
    q = torch.einsum(f"ntvc,kcr->kn{layout}", xr, _dot_in(wm1, dtype)) \
        + bm1[:, None, :, None, None]
    k = torch.einsum(f"ntvc,kcr->kn{layout}", xr, _dot_in(wm2, dtype)) \
        + bm2[:, None, :, None, None]
    s = torch.tanh(q[..., :, None] - k[..., None, :])         # (K,N,R,S,P,P)
    # spatial dyn[t,v,w] = sum_{r,s} s[r,s,v,w] wrm[r,s,t]; temporal
    # dyn[w,t,u] = sum_{r,v} s[r,v,t,u] wrm[r,v,w]
    dyn = torch.einsum("knrsij,krso->knoij", _dot_in(s, dtype),
                       _dot_in(wrm, dtype)) + brm[:, None, :, None, None]
    adj = dyn * a + base_adj[:, None, None]
    fn = aggregate_spatial if mode == "spatial" else aggregate_temporal
    return fn(xf, adj, agg, dtype)


def kernel_spatial(x, base_adj, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                   agg: str = "right", dtype=None) -> torch.Tensor:
    """The spatial op as the fused kernels compute it with a compute
    ``dtype``: the operands of the four contractions (``x wqk``, ``x wf``,
    ``s wrm``, ``adj xf``) rounded to ``dtype``, everything else (q/k, the
    tanh, the mixing sums, ``(dyn + brm) alpha + base``) in float32 (in
    float64 for float64 weights: a reference of the same rounding).
    Returns the float32 output before the kernels' wrapper casts it to
    ``dtype``; with ``dtype`` None it is :func:`dstd_spatial` in float32."""
    return _kernel_op("spatial", x, base_adj, alpha, wf, bf, wm1, bm1, wm2,
                      bm2, wrm, brm, agg, dtype)


def kernel_temporal(x, base_adj, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm,
                    brm, agg: str = "right", dtype=None) -> torch.Tensor:
    """The temporal op as the fused kernels compute it (see
    :func:`kernel_spatial`)."""
    return _kernel_op("temporal", x, base_adj, alpha, wf, bf, wm1, bm1, wm2,
                      bm2, wrm, brm, agg, dtype)
