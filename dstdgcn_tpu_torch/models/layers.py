"""PyTorch building blocks of the DSTD-GCN family.

Counterparts of ``dstdgcn_tpu/models/layers.py`` over channels-last
``(N, T, V, C)`` tensors.  Submodules, parameters and buffers are named
after the flax tree (``block.spatial.wf``, ``bn.mean``) so
:mod:`..utils.bridge` can load JAX weights by name.  Parameters are created
empty; :meth:`reset_parameters` fills them from an explicit
``torch.Generator`` with the JAX package's initializers.

Train or eval follows ``module.training`` (``model.train()`` /
``model.eval()``) instead of a ``train=`` argument.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
from torch import nn

from ..graphs import skeleton as sk
from ..graphs import temporal as tg
from ..kernels import fused as fk
from ..ops import dstd as ops

__all__ = ["Dense", "JointBatchNorm", "PReLU", "Dropout", "DSTDGC", "DSTDGCB",
           "STGCNNLayer", "reset_all"]

#: accepted values of the ``use_pallas`` routing knob
_USE_PALLAS_VALUES = (True, False, "spatial", "temporal", "serving")


def _kaiming_out(p: torch.Tensor, fan_out: int, g: torch.Generator) -> None:
    """Kaiming-normal, mode fan_out, gain sqrt(2) (std sqrt(2/fan_out))."""
    nn.init.normal_(p, 0.0, math.sqrt(2.0 / fan_out), generator=g)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with flax's ``(Ci, Co)`` kernel layout."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def reset_parameters(self, g: torch.Generator) -> None:
        _kaiming_out(self.kernel, self.kernel.shape[1], g)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class JointBatchNorm(nn.Module):
    """BatchNorm over (joint, channel) pairs across batch x time.

    Every (v, c) feature is normalized over the N*T samples; in training the
    running statistics follow torch's momentum (0.1) with the unbiased
    batch variance.
    """

    def __init__(self, joints: int, channels: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
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
        if self.training:
            cnt = x.shape[0] * x.shape[1]
            mean = x.mean(dim=(0, 1))
            var = (x * x).mean(dim=(0, 1)) - mean * mean
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (cnt / max(cnt - 1, 1))
                self.mean.mul_(1 - m).add_(m * mean)
                self.var.mul_(1 - m).add_(m * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * inv + self.bias


class PReLU(nn.Module):
    """Single-parameter PReLU, initial slope 0.25."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.init = init
        self.negative_slope = nn.Parameter(torch.tensor(init))

    def reset_parameters(self, g: torch.Generator) -> None:
        del g
        with torch.no_grad():
            self.negative_slope.fill_(self.init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.negative_slope * x)


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit ``generator``.

    In train mode each element is kept with probability ``1 - p`` and scaled
    by ``1 / (1 - p)``.  The mask is drawn on the generator's device and
    moved to the input's; torch's global generator is never used.
    """

    def __init__(self, p: float, generator: torch.Generator):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0:
            return x
        if self.p >= 1:
            return torch.zeros_like(x)
        g = self.generator
        keep = torch.rand(x.shape, generator=g, device=g.device) >= self.p
        return x * keep.to(device=x.device, dtype=x.dtype) / (1 - self.p)


class DSTDGC(nn.Module):
    """K stacked Dynamic SpatioTemporal Decompose Graph Convolutions.

    The caller supplies the K static base adjacencies and the dynamic gate
    ``alpha``.  ``use_pallas`` routes the op through the CUDA kernel of
    :mod:`..kernels.fused`: ``True`` both ops, ``"spatial"`` /
    ``"temporal"`` one of them, ``"serving"`` both but only in eval mode.
    A routed op that needs a gradient runs the forward kernel and, in the
    backward pass, the backward kernel (:class:`..kernels.fused.FusedOp`).
    """

    def __init__(self, in_channels: int, out_channels: int, ref_len: int,
                 num_kernels: int = 1, red_channels: int = 2,
                 mode: str = "spatial", agg: str = "right",
                 use_pallas: Union[bool, str] = False,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        if mode not in ("spatial", "temporal"):
            raise ValueError(f"mode={mode!r}: expected spatial or temporal")
        if use_pallas not in _USE_PALLAS_VALUES:
            raise ValueError(
                f"use_pallas={use_pallas!r}: expected True, False, "
                "'spatial', 'temporal' or 'serving'")
        self.mode, self.agg, self.use_pallas = mode, agg, use_pallas
        self.compute_dtype = compute_dtype
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
        if self.routed():
            fn = fk.dstd_spatial if self.mode == "spatial" else \
                fk.dstd_temporal
        else:
            fn = ops.dstd_spatial if self.mode == "spatial" else \
                ops.dstd_temporal
        return fn(*args, agg=self.agg, dtype=dtype)


class DSTDGCB(nn.Module):
    """DSTD-GC block: spatial op + BN + residual + PReLU + temporal op.

    Static adjacency: the qualitative variant's spatial base is
    ``R_s.detach() * W_s + R_s`` (the reference's ``R_s`` parameter aliases
    the storage of its "fixed" ``A_s``, so the fixed factor tracks ``R_s``
    while autograd treats it as constant); ``W_s`` is a learnable gate
    (init 0) and ``R_s`` learnable (init the adjacency stack).  The fast
    variant learns one ``A_s`` (init the adjacency stack).  The temporal
    base is ``A_t + R_t`` with ``A_t`` the fixed "neighboor" matrix and
    ``R_t`` learnable (init 0).
    """

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 joint_dim: int, layout: str = "h36m", fast: bool = False,
                 use_pallas: Union[bool, str] = False,
                 compute_dtype: Optional[str] = None):
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
            self.residual_bn = JointBatchNorm(joint_dim, co)
        agg = "left" if fast else "right"
        self.spatial = DSTDGC(ci, co, time_dim, ks, mode="spatial", agg=agg,
                              use_pallas=use_pallas,
                              compute_dtype=compute_dtype)
        self.bn = JointBatchNorm(joint_dim, co)
        self.prelu = PReLU()
        self.temporal = DSTDGC(co, co, joint_dim, kt, mode="temporal",
                               agg=agg, use_pallas=use_pallas,
                               compute_dtype=compute_dtype)

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


class STGCNNLayer(nn.Module):
    """Spatiotemporal layer: a DSTD-GC block plus an optional residual.

    The refine form only (the JAX layer's ``refine=True``, which every
    DSTDGCN layer uses); the legacy ConvTemporalGraphical form is used by
    no shipped config and waits for a later slice.
    """

    def __init__(self, in_channels: int, out_channels: int, time_dim: int,
                 joints_dim: int, residual: bool = True,
                 layout: str = "h36m", fast: bool = False,
                 use_pallas: Union[bool, str] = False,
                 compute_dtype: Optional[str] = None):
        super().__init__()
        self.residual = residual
        if residual and in_channels != out_channels:
            self.residual_proj = Dense(in_channels, out_channels)
        self.block = DSTDGCB(in_channels, out_channels, time_dim, joints_dim,
                             layout=layout, fast=fast, use_pallas=use_pallas,
                             compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = None
        if self.residual:
            res = self.residual_proj(x) if hasattr(self, "residual_proj") \
                else x
        y = self.block(x)
        return y if res is None else y + res


def reset_all(module: nn.Module, g: torch.Generator) -> None:
    """Call ``reset_parameters(g)`` on every submodule that has one, in
    registration order."""
    for m in module.modules():
        fn = getattr(m, "reset_parameters", None)
        if fn is not None and m is not module:
            fn(g)
