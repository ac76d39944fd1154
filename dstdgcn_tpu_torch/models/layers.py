"""PyTorch building blocks of the DSTD-GCN family.

Counterparts of ``dstdgcn_tpu/models/layers.py`` over channels-last
``(N, T, V, C)`` tensors.  Submodules, parameters and buffers are named
after the flax tree (``block.spatial.wf``, ``bn.mean``) so
:mod:`..utils.bridge` can load JAX weights by name.  Parameters are created
empty; :meth:`reset_parameters` fills them from an explicit
``torch.Generator`` with the JAX package's initializers.

Train or eval follows ``module.training`` (``model.train()`` /
``model.eval()``) instead of a ``train=`` argument.

Under an active mesh with a ``graph`` or ``model`` axis above 1
(:func:`..parallel.mesh.splitting_mesh`; the engine enters it) each layer
works on this rank's shard of the activation: its joint range
(``mesh.joints``) and, for a width the model axis divides, its column range
(``mesh.channels``, ``param_sharding``'s rule); a width the axis does not
divide is computed whole on every rank.  Parameters and statistics stay
whole; a layer uses their rows and columns.  A layer that mixes channels
gathers its input's channels first; a DSTD-GC op mixes joints as its
formulation asks (:class:`DSTDGC`).  The legacy ``STGCNNLayer(refine=
False)``, which no config uses, takes no split.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint

from ..graphs import skeleton as sk
from ..graphs import temporal as tg
from ..kernels import fused as fk
from ..ops import dstd as ops
from ..parallel import mesh as pmesh
from ..parallel import shard
from ..parallel.collectives import (all_reduce_sum, gather_channels,
                                    gather_joints)

__all__ = ["Dense", "Conv", "JointBatchNorm", "PReLU", "Dropout", "DSTDGC",
           "DSTDGCB", "ConvTemporalGraphical", "STGCNNLayer", "reset_all"]

#: accepted values of the ``use_pallas`` routing knob
_USE_PALLAS_VALUES = (True, False, "spatial", "temporal", "serving")
#: the products whose outputs ``remat="dots"`` saves (``dots_saveable``):
#: einsum and matmul reach autograd as these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _kaiming_out(p: torch.Tensor, fan_out: int, g: torch.Generator) -> None:
    """Kaiming-normal, mode fan_out, gain sqrt(2) (std sqrt(2/fan_out))."""
    nn.init.normal_(p, 0.0, math.sqrt(2.0 / fan_out), generator=g)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with flax's ``(Ci, Co)`` kernel layout;
    under a model axis the input's channels gathered and this rank's output
    columns computed."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, g: torch.Generator) -> None:
        _kaiming_out(self.kernel, self.kernel.shape[1], g)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = pmesh.splitting_mesh()
        if mesh is None:
            return x @ self.kernel + self.bias
        x = gather_channels(mesh, x, self.kernel.shape[0])
        cols = mesh.channels(self.kernel.shape[1])
        return x @ self.kernel[:, cols] + self.bias[cols]


def _shard(mesh, y: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a whole (N, T, V, C) activation."""
    return y[:, :, mesh.joints(y.shape[2]), mesh.channels(y.shape[3])]


class Conv(nn.Module):
    """flax ``nn.Conv`` over the (T, V) axes of ``(N, T, V, C)``: a
    ``(kh, kw, Ci, Co)`` kernel, a bias, strides ``(stride, stride)`` and
    ``SAME`` padding (the extra row or column of an odd total at the
    end)."""

    def __init__(self, in_features: int, out_features: int,
                 kernel_size: Tuple[int, int] = (1, 1), stride: int = 1):
        super().__init__()
        kh, kw = kernel_size
        self.stride = stride
        self.kernel = nn.Parameter(torch.empty(kh, kw, in_features,
                                               out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, g: torch.Generator) -> None:
        kh, kw, _, co = self.kernel.shape
        _kaiming_out(self.kernel, co * kh * kw, g)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel.shape[:2]
        pads = []
        for size, k in ((x.shape[2], kw), (x.shape[1], kh)):
            out = -(-size // self.stride)
            total = max((out - 1) * self.stride + k - size, 0)
            pads += [total // 2, total - total // 2]
        y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), pads),
                     self.kernel.permute(3, 2, 0, 1), self.bias,
                     stride=self.stride)
        return y.permute(0, 2, 3, 1)


class JointBatchNorm(nn.Module):
    """BatchNorm over (joint, channel) pairs across batch x time.

    Every (v, c) feature is normalized over the N*T samples; in training the
    running statistics follow torch's momentum (0.1) with the unbiased
    batch variance, computed in the parameters' type (float32, or float64
    in a float64 model) whatever the input's dtype.  The output is cast to
    ``dtype`` (the JAX module's ``dtype``: the DSTD-GC block sets its
    activation dtype); with ``None`` it keeps the arithmetic's type,
    float32 for a float32 or bf16 input.

    In training under a mesh (the engine enters it,
    :func:`..parallel.mesh.activation_sharding_context`), ``mean`` and
    ``mean_sq`` are averaged over the ranks of a group and ``cnt`` counts
    the group's samples (the JAX module's ``pmean`` over ``axis_name``), the
    gradient flowing back through the reduction: over the mesh's
    ``axis_name`` group when one is named (a ``ValueError`` without such a
    mesh), else over its data group when that has more than one rank
    (:func:`..parallel.mesh.stats_group`).  Under a graph or model axis the
    layer normalizes this rank's (joint, channel) block with those rows and
    columns of ``scale``, ``bias``, ``mean`` and ``var``, and updates that
    block of the running statistics alone (the engine gathers the blocks
    after a step); the statistics are per (joint, channel), so nothing is
    reduced over ``graph`` or ``model``.
    """

    def __init__(self, joints: int, channels: int, momentum: float = 0.1,
                 eps: float = 1e-5, dtype: Optional[torch.dtype] = None,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.axis_name = axis_name
        self.scale = nn.Parameter(torch.ones(joints, channels))
        self.bias = nn.Parameter(torch.zeros(joints, channels))
        self.register_buffer("mean", torch.zeros(joints, channels))
        self.register_buffer("var", torch.ones(joints, channels))

    def reset_parameters(self, g: torch.Generator) -> None:
        del g
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale, bias, run_mean, run_var = self.scale, self.bias, self.mean, \
            self.var
        mesh = pmesh.splitting_mesh()
        if mesh is not None:    # this rank's (joint, channel) block
            block = (mesh.joints(scale.shape[0]),
                     mesh.channels(scale.shape[1]))
            scale, bias, run_mean, run_var = (
                t[block] for t in (scale, bias, run_mean, run_var))
        if self.training:
            xf = x.to(torch.promote_types(x.dtype, scale.dtype))
            cnt = x.shape[0] * x.shape[1]
            mean = xf.mean(dim=(0, 1))
            mean_sq = (xf * xf).mean(dim=(0, 1))
            sync = pmesh.stats_group(self.axis_name)
            if sync is not None:
                group, size = sync
                mean, mean_sq = all_reduce_sum(
                    torch.stack([mean, mean_sq]), group) / size
                cnt = cnt * size
            var = mean_sq - mean * mean
            with torch.no_grad():   # in place: a block is a view
                m = self.momentum
                unbiased = var * (cnt / max(cnt - 1, 1))
                run_mean.mul_(1 - m).add_(m * mean)
                run_var.mul_(1 - m).add_(m * unbiased)
        else:
            mean, var = run_mean, run_var
        inv = torch.rsqrt(var + self.eps) * scale
        out = (x - mean) * inv + bias
        return out if self.dtype is None else out.to(self.dtype)


class PReLU(nn.Module):
    """Single-parameter PReLU, initial slope 0.25; the slope is cast to the
    input's dtype, so a bf16 input stays bf16 as in the JAX module."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.init = init
        self.negative_slope = nn.Parameter(torch.tensor(init))

    def reset_parameters(self, g: torch.Generator) -> None:
        del g
        with torch.no_grad():
            self.negative_slope.fill_(self.init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x,
                           self.negative_slope.to(x.dtype) * x)


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit ``generator``.

    In train mode each element is kept with probability ``1 - p`` and scaled
    by ``1 / (1 - p)``.  The mask is drawn on the generator's device and
    moved to the input's; torch's global generator is never used.  Under a
    graph or model axis the mask of the whole (N, T, ``features``)
    activation is drawn, as one rank would, and the rank keeps its block:
    the ranks of one data index draw from equal generators, so their blocks
    tile one mask.
    """

    def __init__(self, p: float, generator: torch.Generator,
                 features: Tuple[int, int]):
        super().__init__()
        self.p = p
        self.generator = generator
        #: the whole (V, C) of the input, which a split mask needs
        self.features = tuple(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        if self.p >= 1:
            return torch.zeros_like(x)
        g = self.generator
        mesh = pmesh.splitting_mesh()
        if mesh is None:
            keep = torch.rand(x.shape, generator=g, device=g.device) >= self.p
        else:
            keep = _shard(mesh, torch.rand(
                x.shape[:2] + self.features, generator=g,
                device=g.device) >= self.p)
        return x * keep.to(device=x.device, dtype=x.dtype) / (1 - self.p)


class DSTDGC(nn.Module):
    """K stacked Dynamic SpatioTemporal Decompose Graph Convolutions.

    The caller supplies the K static base adjacencies and the dynamic gate
    ``alpha``.  ``use_pallas`` routes the op through the CUDA kernel of
    :mod:`..kernels.fused`: ``True`` both ops, ``"spatial"`` /
    ``"temporal"`` one of them, ``"serving"`` both but only in eval mode.
    A routed op that needs a gradient runs the forward kernel and, in the
    backward pass, the backward kernel (:class:`..kernels.fused.FusedOp`).

    ``remat`` recomputes the op in the backward pass
    (``torch.utils.checkpoint``, non-reentrant, around exactly the op call,
    as ``jax.checkpoint`` wraps it): ``True`` saves nothing of the op's
    inside; ``"dots"`` saves the outputs of its products (``mm``, ``bmm``)
    and recomputes the rest, as ``dots_saveable`` does.  On the kernel path
    the op is one autograd Function whose forward is a kernel no policy can
    see into, so ``"dots"`` recomputes it as ``True`` does: the forward
    kernel runs again in the backward pass, and the backward kernel reads
    the same saved inputs.  No dropout or BatchNorm sits in the region.

    Under a graph or model axis the op runs on this rank's shard
    (:func:`_split_op`); under remat its collectives sit inside the
    recomputed region and run again in the backward pass, in the same order
    on every rank.
    """

    def __init__(self, in_channels: int, out_channels: int, ref_len: int,
                 num_kernels: int = 1, red_channels: int = 2,
                 mode: str = "spatial", agg: str = "right",
                 use_pallas: Union[bool, str] = False,
                 compute_dtype: Optional[str] = None,
                 remat: Union[bool, str] = False):
        super().__init__()
        if mode not in ("spatial", "temporal"):
            raise ValueError(f"mode={mode!r}: expected spatial or temporal")
        if use_pallas not in _USE_PALLAS_VALUES:
            raise ValueError(
                f"use_pallas={use_pallas!r}: expected True, False, "
                "'spatial', 'temporal' or 'serving'")
        self.mode, self.agg, self.use_pallas = mode, agg, use_pallas
        self.compute_dtype = compute_dtype
        self.remat = remat
        k, ci, co, r, ref = (num_kernels, in_channels, out_channels,
                             red_channels, ref_len)
        self.wf = nn.Parameter(torch.empty(k, ci, co))
        self.bf = nn.Parameter(torch.empty(k, co))
        self.wm1 = nn.Parameter(torch.empty(k, ci, r))
        self.bm1 = nn.Parameter(torch.empty(k, r))
        self.wm2 = nn.Parameter(torch.empty(k, ci, r))
        self.bm2 = nn.Parameter(torch.empty(k, r))
        self.wrm = nn.Parameter(torch.empty(k, r, ref, ref))
        self.brm = nn.Parameter(torch.empty(k, ref))

    def reset_parameters(self, g: torch.Generator) -> None:
        co, r, ref = self.wf.shape[-1], self.wm1.shape[-1], self.wrm.shape[-1]
        for w, fan in ((self.wf, co), (self.wm1, r), (self.wm2, r),
                       (self.wrm, ref)):
            _kaiming_out(w, fan, g)
        for b in (self.bf, self.bm1, self.bm2, self.brm):
            nn.init.zeros_(b)

    def routed(self) -> bool:
        """True when this op goes through the CUDA kernel wrapper."""
        return bool(self.use_pallas) and (
            self.use_pallas is True or self.use_pallas == self.mode
            or (self.use_pallas == "serving" and not self.training))

    def forward(self, x, base_adj, alpha, mask=None) -> torch.Tensor:
        dtype = (None if self.compute_dtype is None
                 else getattr(torch, self.compute_dtype))
        args = (x, base_adj, alpha, self.wf, self.bf, self.wm1, self.bm1,
                self.wm2, self.bm2, self.wrm, self.brm, mask)
        routed = self.routed()
        if routed:
            fn = fk.dstd_spatial if self.mode == "spatial" else \
                fk.dstd_temporal
        else:
            fn = ops.dstd_spatial if self.mode == "spatial" else \
                ops.dstd_temporal
        mesh = pmesh.splitting_mesh()
        if mesh is not None:
            fn = functools.partial(_split_op, mesh, self.mode, fn, routed)
        if not (self.remat and torch.is_grad_enabled()):
            return fn(*args, agg=self.agg, dtype=dtype)
        context_fn = checkpoint.noop_context_fn
        if self.remat == "dots":
            context_fn = functools.partial(
                checkpoint.create_selective_checkpoint_contexts, _save_dots)
        return checkpoint.checkpoint(fn, *args, agg=self.agg, dtype=dtype,
                                     use_reentrant=False,
                                     context_fn=context_fn)


def _split_op(mesh, mode, op, routed, x, base, alpha, wf, bf, wm1, bm1, wm2,
              bm2, wrm, brm, mask=None, agg="right", dtype=None):
    """One DSTD-GC op ``op`` (kernel wrapper or plain) on this rank's shard
    of x under a graph or model axis; returns the rank's shard of the
    output.

    Model axis: the input's channels are gathered, q and k come from the
    whole input with the replicated weights, and the rank computes its
    output columns with ``wf[..., cols]`` and ``bf[..., cols]`` (all of
    them when the axis does not divide the width).  Graph axis: the plain
    float32 op runs edge-partitioned on the rank's joints
    (:mod:`..parallel.shard`, for its mode and ``agg``); the kernel path
    (``routed``), a compute dtype or a mask gather the joints, run the op
    on all of them as GSPMD runs a custom call on whole operands, and keep
    the rank's rows: the gather's backward sums every rank's share of
    ``dx``.
    """
    ci, co = wf.shape[1], wf.shape[2]
    x = gather_channels(mesh, x, ci)
    cols = mesh.channels(co)
    wf, bf = wf[..., cols], bf[..., cols]
    if routed:              # the kernels read contiguous operands
        wf, bf = wf.contiguous(), bf.contiguous()
    v = base.shape[-1] if mode == "spatial" else wrm.shape[-1]
    rest = (base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm)
    if mesh.shape.get("graph", 1) == 1:
        return op(x.contiguous() if routed else x, *rest, mask, agg=agg,
                  dtype=dtype)
    if not routed and dtype is None and mask is None:
        fn = shard.dstd_spatial_edge_partitioned if mode == "spatial" \
            else shard.dstd_temporal_edge_partitioned
        return fn(mesh, x, *rest, agg=agg)
    whole = gather_joints(mesh, x, v).contiguous()
    return op(whole, *rest, mask, agg=agg, dtype=dtype)[:, :,
                                                        mesh.joints(v)]


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots_saveable`` policy: keep the products' outputs."""
    del ctx, args, kwargs
    return (checkpoint.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


class DSTDGCB(nn.Module):
    """DSTD-GC block: spatial op + BN + residual + PReLU + temporal op.

    Static adjacency: the qualitative variant's spatial base is
    ``R_s.detach() * W_s + R_s`` (the reference's ``R_s`` parameter aliases
    the storage of its "fixed" ``A_s``, so the fixed factor tracks ``R_s``
    while autograd treats it as constant); ``W_s`` is a learnable gate
    (init 0) and ``R_s`` learnable (init the adjacency stack).  The fast
    variant learns one ``A_s`` (init the adjacency stack).  The temporal
    base is ``A_t + R_t`` with ``A_t`` the fixed "neighboor" matrix and
    ``R_t`` learnable (init 0).  With a ``compute_dtype`` the block's
    activations flow in that dtype as in the JAX block: both ops emit it,
    ``bn`` and ``residual_bn`` cast to it, and the PReLU keeps it.
    ``remat`` goes to both ops (:class:`DSTDGC`), ``bn_axis_name`` to both
    BatchNorms (:class:`JointBatchNorm`'s ``axis_name``).
    """

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 joint_dim: int, layout: str = "h36m", fast: bool = False,
                 use_pallas: Union[bool, str] = False,
                 compute_dtype: Optional[str] = None,
                 remat: Union[bool, str] = False,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        a_s = sk.stacked_adjacency(layout)                  # (2, V, V)
        a_t = tg.stacked_adjacency(time_dim)                # (1, T, T)
        if a_s.shape[1] != joint_dim:
            raise ValueError(f"layout {layout!r} has {a_s.shape[1]} joints, "
                             f"model expects {joint_dim}")
        self.fast, self.time_dim, self.joint_dim = fast, time_dim, joint_dim
        self._a_s = a_s
        ks, kt = a_s.shape[0], a_t.shape[0]
        if fast:
            self.A_s = nn.Parameter(torch.empty(a_s.shape))
        else:
            self.W_s = nn.Parameter(torch.empty(a_s.shape))
            self.R_s = nn.Parameter(torch.empty(a_s.shape))
        self.R_t = nn.Parameter(torch.empty(a_t.shape))
        self.register_buffer("A_t", torch.from_numpy(a_t), persistent=False)
        self.alpha_sm = nn.Parameter(torch.empty(1))
        self.alpha_tm = nn.Parameter(torch.empty(1))

        ci, co = in_channels, out_channels
        if ci != co:
            self.residual_proj = Dense(ci, co)
            self.residual_bn = JointBatchNorm(joint_dim, co,
                                              axis_name=bn_axis_name)
        agg = "left" if fast else "right"
        self.spatial = DSTDGC(ci, co, time_dim, ks, mode="spatial", agg=agg,
                              use_pallas=use_pallas, remat=remat)
        self.bn = JointBatchNorm(joint_dim, co, axis_name=bn_axis_name)
        self.prelu = PReLU()
        self.temporal = DSTDGC(co, co, joint_dim, kt, mode="temporal",
                               agg=agg, use_pallas=use_pallas, remat=remat)
        self.set_compute_dtype(compute_dtype)

    def set_compute_dtype(self, compute_dtype: Optional[str]) -> None:
        """Set the compute dtype of both ops and the activation dtype of the
        block's BatchNorms (None: float32)."""
        self.spatial.compute_dtype = self.temporal.compute_dtype = \
            compute_dtype
        act = None if compute_dtype is None else getattr(torch, compute_dtype)
        self.bn.dtype = act
        if hasattr(self, "residual_bn"):
            self.residual_bn.dtype = act

    def reset_parameters(self, g: torch.Generator) -> None:
        with torch.no_grad():
            a_s = torch.from_numpy(self._a_s)
            if self.fast:
                self.A_s.copy_(a_s)
            else:
                self.W_s.zero_()
                self.R_s.copy_(a_s)
            self.R_t.zero_()
            self.alpha_sm.zero_()
            self.alpha_tm.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.fast:
            base_s = self.A_s
        else:
            base_s = self.R_s.detach() * self.W_s + self.R_s
        base_t = self.A_t + self.R_t
        if hasattr(self, "residual_proj"):
            res = self.residual_bn(self.residual_proj(x))
        else:
            res = x
        y = self.spatial(x, base_s, self.alpha_sm)
        y = self.prelu(self.bn(y) + res)
        return self.temporal(y, base_t, self.alpha_tm)


class ConvTemporalGraphical(nn.Module):
    """Legacy ST-GCN unit: learnable per-joint temporal mixing ``T (V, T,
    T)``, then per-frame joint mixing by ``A (T, V, V)`` plus the fixed
    skeleton adjacency.  Used by no shipped config (every DSTDGCN layer is
    a refine layer), as in the JAX package."""

    def __init__(self, time_dim: int, joints_dim: int,
                 layout: str = "h36m"):
        super().__init__()
        t, v = time_dim, joints_dim
        self.A = nn.Parameter(torch.empty(t, v, v))
        self.T = nn.Parameter(torch.empty(v, t, t))
        self.register_buffer(
            "a_fixed", torch.from_numpy(sk.adjacency(layout, "all")),
            persistent=False)

    def reset_parameters(self, g: torch.Generator) -> None:
        t, v = self.A.shape[0], self.A.shape[1]
        with torch.no_grad():
            for p, bound in ((self.A, 1.0 / math.sqrt(v)),
                             (self.T, 1.0 / math.sqrt(t))):
                p.uniform_(-bound, bound, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.einsum("ntvc,vtq->nqvc", x, self.T)
        return torch.einsum("ntvc,tvw->ntwc", y,
                            self.A + self.a_fixed.to(self.A.dtype))


class STGCNNLayer(nn.Module):
    """Spatiotemporal layer plus an optional residual: a DSTD-GC block
    (``refine=True``, every DSTDGCN layer) or the legacy form
    (``refine=False``: :class:`ConvTemporalGraphical`, then a
    ``kernel_size`` / ``stride`` convolution padded ``SAME``)."""

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 joints_dim: int, kernel_size: Tuple[int, int] = (1, 1),
                 stride: int = 1, refine: bool = True, residual: bool = True,
                 layout: str = "h36m", fast: bool = False,
                 use_pallas: Union[bool, str] = False,
                 compute_dtype: Optional[str] = None,
                 remat: Union[bool, str] = False,
                 bn_axis_name: Optional[str] = None):
        super().__init__()
        self.residual = residual
        if residual and (stride != 1 or in_channels != out_channels):
            self.residual_proj = Dense(in_channels, out_channels)
        if refine:
            self.block = DSTDGCB(in_channels, out_channels, time_dim,
                                 joints_dim, layout=layout, fast=fast,
                                 use_pallas=use_pallas,
                                 compute_dtype=compute_dtype, remat=remat,
                                 bn_axis_name=bn_axis_name)
        else:
            self.tgcn = ConvTemporalGraphical(time_dim, joints_dim, layout)
            self.conv = Conv(in_channels, out_channels, kernel_size, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = None
        if self.residual:
            res = self.residual_proj(x) if hasattr(self, "residual_proj") \
                else x
        y = self.block(x) if hasattr(self, "block") else \
            self.conv(self.tgcn(x))
        return y if res is None else y + res


def reset_all(module: nn.Module, g: torch.Generator) -> None:
    """Call ``reset_parameters(g)`` on every submodule that has one, in
    registration order."""
    for m in module.modules():
        fn = getattr(m, "reset_parameters", None)
        if fn is not None and m is not module:
            fn(g)
