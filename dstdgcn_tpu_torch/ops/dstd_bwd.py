"""Backward of the DSTD-GC ops in plain PyTorch, derived by hand.

The plain version of the two backward CUDA kernels
(``csrc/dstd_spatial_bwd.cu`` / ``csrc/dstd_temporal_bwd.cu``) and the
counterpart of ``dstdgcn_tpu/kernels/fused_bwd.py::spatial_bwd`` /
``::temporal_bwd``.  From the saved input ``x`` and the cotangent ``g`` of
the op's output, each function recomputes the projections, the tanh scores
and the adjacency, then applies the chain rule step by step: dxf and dA
through the aggregation, dalpha, dbase, dbrm, ddyn, dwrm, the score
cotangent ds, du = ds (1 - s^2), dq and dk, and the projections' weight
gradients.  No autograd: the CPU tests hold this derivation against autograd
of :mod:`.dstd` and against the JAX package's Pallas backward.

Both return the 11 gradients in the order of the JAX package:
``(dx, dbase, dalpha, dwf, dbf, dwm1, dbm1, dwm2, dbm2, dwrm, dbrm)``, each
in its input's layout (``dalpha`` takes alpha's shape).  Shapes and weights
as in :mod:`.dstd`; ``mask`` is not supported (a masked op takes autograd of
the plain forward).

``dtype`` (e.g. ``torch.bfloat16``) is the backward kernels' compute dtype
(``fused_bwd.py::_spatial_bwd_kernel`` / ``_temporal_bwd_kernel`` with a
``dtype``): ``x`` and ``g`` enter as float32 (as float64 with float64
weights, a reference of the same rounding), the operands of the 11
contractions (the q/k and feature projections, the mixing, dxf, dwf, dx
from dxf, dA, dwrm, ds, dwqk and dx from dq/dk) are rounded to ``dtype``,
and every other step (tanh, du, the bias, base, alpha and brm sums) stays
in the wide type; the gradients are float32 (float64).  The forward it
differentiates is :func:`.dstd.kernel_spatial` / ``kernel_temporal``.
"""

from __future__ import annotations

import functools

import torch

from .dstd import _check_agg, _dot_in, _wide

__all__ = ["dstd_spatial_bwd", "dstd_temporal_bwd"]


def _alpha(alpha, x):
    return torch.as_tensor(alpha, dtype=x.dtype, device=x.device)


def dstd_spatial_bwd(x, g, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                     agg: str = "right", dtype=None):
    """Gradients of :func:`.dstd.dstd_spatial` (mask None, float32 or
    float64; with ``dtype``, of :func:`.dstd.kernel_spatial`) at ``x`` for
    the output cotangent ``g`` (N,T,V,Co)."""
    _check_agg(agg)
    if dtype is not None:     # bf16 x and g enter as float32 (or float64)
        x, g = x.to(_wide(x, wf)), g.to(_wide(x, wf))
    r = functools.partial(_dot_in, dtype=dtype)   # a contraction operand
    alpha_t = _alpha(alpha, x)
    a = alpha_t.reshape(())
    xr, gr = r(x), r(g)
    # recompute: features (K,N,T,V,Co), q/k (K,N,R,S,V), scores
    # (K,N,R,S,V,W), dyn with brm and the adjacency (K,N,T,V,W)
    xf = torch.einsum("ntvc,kcd->kntvd", xr, r(wf)) \
        + bf[:, None, None, None, :]
    q = torch.einsum("ntvc,kcr->knrtv", xr, r(wm1)) \
        + bm1[:, None, :, None, None]
    k = torch.einsum("ntvc,kcr->knrtv", xr, r(wm2)) \
        + bm2[:, None, :, None, None]
    s = torch.tanh(q[..., :, None] - k[..., None, :])
    dyn = torch.einsum("knrsvw,krst->kntvw", r(s), r(wrm)) \
        + brm[:, None, :, None, None]
    adj = dyn * a + base[:, None, None]
    # aggregation: right out[t,w] = sum_v xf[t,v] adj[t,v,w];
    #              left  out[t,v] = sum_w adj[t,v,w] xf[t,w]
    if agg == "right":
        dxf = torch.einsum("kntvw,ntwc->kntvc", r(adj), gr)
        dadj = torch.einsum("kntvc,ntwc->kntvw", r(xf), gr)
    else:
        dxf = torch.einsum("kntvw,ntvc->kntwc", r(adj), gr)
        dadj = torch.einsum("ntvc,kntwc->kntvw", gr, r(xf))
    dbase = dadj.sum(dim=(1, 2))
    dalpha = (dadj * dyn).sum().reshape(alpha_t.shape)
    ddyn = a * dadj
    dbrm = ddyn.sum(dim=(1, 3, 4))
    # mixing: dyn[t,v,w] = sum_{r,s} s[r,s,v,w] wrm[r,s,t]
    dwrm = torch.einsum("knrsvw,kntvw->krst", r(s), r(ddyn))
    ds = torch.einsum("krst,kntvw->knrsvw", r(wrm), r(ddyn))
    du = ds * (1 - s * s)
    dq = du.sum(dim=-1)                                   # (K,N,R,S,V)
    dk = -du.sum(dim=-2)                                  # (K,N,R,S,W)
    dwf = torch.einsum("ntvc,kntvd->kcd", xr, r(dxf))
    dbf = dxf.sum(dim=(1, 2, 3))
    dwm1 = torch.einsum("ntvc,knrtv->kcr", xr, r(dq))
    dbm1 = dq.sum(dim=(1, 3, 4))
    dwm2 = torch.einsum("ntvc,knrtv->kcr", xr, r(dk))
    dbm2 = dk.sum(dim=(1, 3, 4))
    dx = (torch.einsum("kntvd,kcd->ntvc", r(dxf), r(wf))
          + torch.einsum("knrtv,kcr->ntvc", r(dq), r(wm1))
          + torch.einsum("knrtv,kcr->ntvc", r(dk), r(wm2)))
    return dx, dbase, dalpha, dwf, dbf, dwm1, dbm1, dwm2, dbm2, dwrm, dbrm


def dstd_temporal_bwd(x, g, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                      agg: str = "right", dtype=None):
    """Gradients of :func:`.dstd.dstd_temporal` (mask None, float32 or
    float64; with ``dtype``, of :func:`.dstd.kernel_temporal`) at ``x`` for
    the output cotangent ``g`` (N,T,V,Co)."""
    _check_agg(agg)
    if dtype is not None:     # bf16 x and g enter as float32 (or float64)
        x, g = x.to(_wide(x, wf)), g.to(_wide(x, wf))
    r = functools.partial(_dot_in, dtype=dtype)   # a contraction operand
    alpha_t = _alpha(alpha, x)
    a = alpha_t.reshape(())
    xr, gr = r(x), r(g)
    # recompute: features (K,N,T,V,Co), q/k (K,N,R,V,T), scores
    # (K,N,R,V,T,U), dyn with brm and the adjacency (K,N,W,T,U)
    xf = torch.einsum("ntvc,kcd->kntvd", xr, r(wf)) \
        + bf[:, None, None, None, :]
    q = torch.einsum("ntvc,kcr->knrvt", xr, r(wm1)) \
        + bm1[:, None, :, None, None]
    k = torch.einsum("ntvc,kcr->knrvt", xr, r(wm2)) \
        + bm2[:, None, :, None, None]
    s = torch.tanh(q[..., :, None] - k[..., None, :])
    dyn = torch.einsum("knrvtu,krvw->knwtu", r(s), r(wrm)) \
        + brm[:, None, :, None, None]
    adj = dyn * a + base[:, None, None]
    # aggregation: right out[u,v] = sum_t xf[t,v] adj[v,t,u];
    #              left  out[t,v] = sum_u adj[v,t,u] xf[u,v]
    if agg == "right":
        dxf = torch.einsum("knvtu,nuvc->kntvc", r(adj), gr)
        dadj = torch.einsum("kntvc,nuvc->knvtu", r(xf), gr)
    else:
        dxf = torch.einsum("knvtu,ntvc->knuvc", r(adj), gr)
        dadj = torch.einsum("ntvc,knuvc->knvtu", gr, r(xf))
    dbase = dadj.sum(dim=(1, 2))
    dalpha = (dadj * dyn).sum().reshape(alpha_t.shape)
    ddyn = a * dadj
    dbrm = ddyn.sum(dim=(1, 3, 4))
    # mixing: dyn[w,t,u] = sum_{r,v} s[r,v,t,u] wrm[r,v,w]
    dwrm = torch.einsum("knrvtu,knwtu->krvw", r(s), r(ddyn))
    ds = torch.einsum("krvw,knwtu->knrvtu", r(wrm), r(ddyn))
    du = ds * (1 - s * s)
    dq = du.sum(dim=-1)                                   # (K,N,R,V,T)
    dk = -du.sum(dim=-2)                                  # (K,N,R,V,U)
    dwf = torch.einsum("ntvc,kntvd->kcd", xr, r(dxf))
    dbf = dxf.sum(dim=(1, 2, 3))
    dwm1 = torch.einsum("ntvc,knrvt->kcr", xr, r(dq))
    dbm1 = dq.sum(dim=(1, 3, 4))
    dwm2 = torch.einsum("ntvc,knrvt->kcr", xr, r(dk))
    dbm2 = dk.sum(dim=(1, 3, 4))
    dx = (torch.einsum("kntvd,kcd->ntvc", r(dxf), r(wf))
          + torch.einsum("knrvt,kcr->ntvc", r(dq), r(wm1))
          + torch.einsum("knrvt,kcr->ntvc", r(dk), r(wm2)))
    return dx, dbase, dalpha, dwf, dbf, dwm1, dbm1, dwm2, dbm2, dwrm, dbrm
