"""Wrappers of the whole-op DSTD-GC CUDA kernels, forward and backward.

``dstd_spatial`` and ``dstd_temporal`` keep the argument order of
``dstdgcn_tpu/kernels/fused.py`` (``x, base, alpha, wf, bf, wm1, bm1, wm2,
bm2, wrm, brm, mask, agg, dtype``).  When a gradient is wanted they run as
one ``torch.autograd.Function``: the forward kernel
(``csrc/dstd_spatial.cu`` / ``csrc/dstd_temporal.cu``) saves ``x`` and the
ten weights, and the backward kernel (``csrc/dstd_spatial_bwd.cu`` /
``csrc/dstd_temporal_bwd.cu``) turns the output cotangent into all 11
gradients, as ``jax.custom_vjp`` does in the JAX package.  Without a
gradient (``no_grad``, ``inference_mode``, or no input that requires one) a
call is a single forward launch.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor the same Function runs the plain op of :mod:`..ops.dstd` and the
hand-derived plain backward of :mod:`..ops.dstd_bwd`.  A ``mask``, or a
``dtype`` on the CPU, takes the plain op under autograd; a ``dtype`` on the
card raises (bf16 kernels are not ported).  Every wrapper counts its kernel
launches in ``.launches`` (a plain integer; :func:`reset_launch_counts`
zeroes them); one backward call is :data:`BWD_LAUNCHES` launches.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops import dstd as plain
from ..ops import dstd_bwd as plain_bwd
from . import build

__all__ = ["dstd_spatial", "dstd_temporal", "dstd_spatial_bwd",
           "dstd_temporal_bwd", "FusedOp", "FusedBwd", "launch_counts",
           "reset_launch_counts", "SMEM_LIMIT", "BWD_LAUNCHES"]

#: dynamic shared memory one block may use on Hopper (232,448 bytes)
SMEM_LIMIT = 227 * 1024
#: the kernels' largest output tile and cluster (csrc/dstd_common.cuh):
#: the spatial forward kernel runs the ceil(T / tile) blocks of a sample as
#: one thread-block cluster
MAX_TILE = 8
MAX_CLUSTER = 8
#: y-dimension grid limit: one grid row per sample
MAX_SAMPLES = 65535
#: kernel launches of one backward call: q/k projection, the pass over
#: output tiles, the pass over source tiles, the reduction of the weight
#: gradients (csrc/dstd_bwd_common.cuh)
BWD_LAUNCHES = 4

_WEIGHTS = ("base", "alpha", "wf", "bf", "wm1", "bm1", "wm2", "bm2", "wrm",
            "brm")


class _Kernel:
    """Shape checks, tile choice and the launch count of one CUDA kernel
    library (``build.SOURCES`` name ``name``)."""

    def __init__(self, name: str, mode: str, default_tile: int,
                 clustered: bool):
        self.name = name
        self.mode = mode
        self.default_tile = default_tile
        self.clustered = clustered
        self.launches = 0
        self._plans: Dict[tuple, tuple] = {}

    def _check(self, x, weights, g=None):
        if x.dim() != 4:
            raise ValueError(f"{self.name}: x must be (N,T,V,C), got "
                             f"{tuple(x.shape)}")
        n, t, v, ci = x.shape
        wf, wm1 = weights["wf"], weights["wm1"]
        k, co, r = wf.shape[0], wf.shape[-1], wm1.shape[-1]
        ref = t if self.mode == "spatial" else v      # wrm / brm extent
        pair = v if self.mode == "spatial" else t     # base extent
        want = dict(base=(k, pair, pair), wf=(k, ci, co), bf=(k, co),
                    wm1=(k, ci, r), bm1=(k, r), wm2=(k, ci, r), bm2=(k, r),
                    wrm=(k, r, ref, ref), brm=(k, ref), g=(n, t, v, co))
        args = dict(x=x, **weights)
        if g is not None:
            args["g"] = g
        for key, arr in args.items():
            if not isinstance(arr, torch.Tensor):
                raise TypeError(f"{self.name}: {key} must be a tensor")
            if arr.device != x.device:
                raise ValueError(f"{self.name}: {key} on {arr.device}, x on "
                                 f"{x.device}")
            if arr.dtype != torch.float32:
                raise TypeError(f"{self.name}: {key} is {arr.dtype}; the "
                                "kernel takes float32")
            if not arr.is_contiguous():
                raise ValueError(f"{self.name}: {key} must be contiguous")
            if arr.data_ptr() % 16:
                raise ValueError(f"{self.name}: {key} must start on a "
                                 "16-byte boundary (float4 loads)")
            shape = want.get(key)
            if shape is not None and tuple(arr.shape) != shape:
                raise ValueError(f"{self.name}: {key} has shape "
                                 f"{tuple(arr.shape)}, expected {shape}")
        if weights["alpha"].numel() != 1:
            raise ValueError(f"{self.name}: alpha must hold one value")
        if n > MAX_SAMPLES:
            raise ValueError(f"{self.name}: batch {n} exceeds {MAX_SAMPLES}")
        return n, t, v, ci, co, k, r

    def _tile(self, lib, t, v, ci, co, k, r, tile):
        """Largest tile <= the requested one whose block fits in shared
        memory and, for a clustered kernel, whose sample fits in one cluster
        of MAX_CLUSTER blocks."""
        smem = getattr(lib, f"{self.name}_smem_bytes")
        extent = t if self.mode == "spatial" else v
        lowest = -(-extent // MAX_CLUSTER) if self.clustered else 1
        tile = min(max(tile or self.default_tile, lowest), extent, MAX_TILE)
        for size in range(tile, lowest - 1, -1):
            if smem(t, v, ci, co, k, r, size) <= SMEM_LIMIT:
                return size
        raise ValueError(
            f"{self.name}: T={t}, V={v}, {ci}->{co} channels need a tile of "
            f"{lowest}..{MAX_TILE} within {SMEM_LIMIT} bytes of shared "
            "memory")

    def _plan(self, n, t, v, ci, co, k, r, tile):
        """(library, tile, scratch floats) of a call shape, looked up once:
        the tile search asks the library for shared-memory sizes."""
        key = (n, t, v, ci, co, k, r, tile)
        plan = self._plans.get(key)
        if plan is None:
            lib = build.library(self.name)
            size = self._tile(lib, t, v, ci, co, k, r, tile)
            scratch = getattr(lib, f"{self.name}_scratch_floats", None)
            floats = 0 if scratch is None else scratch(n, t, v, ci, co, k,
                                                       r, size)
            plan = self._plans[key] = (lib, size, floats)
        return plan

    def _raise_on(self, lib, err):
        if err != 0:
            msg = lib.dstd_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"cudaError {err} ({msg})")


class FusedBwd(_Kernel):
    """Backward of one DSTD-GC op: CUDA kernel on the card, the plain
    backward of :mod:`..ops.dstd_bwd` on the CPU.  Returns the 11 gradients
    ``(dx, dbase, dalpha, dwf, dbf, dwm1, dbm1, dwm2, dbm2, dwrm, dbrm)``."""

    def __init__(self, mode: str, plain_fn, default_tile: int):
        super().__init__(f"dstd_{mode}_bwd", mode, default_tile,
                         clustered=False)
        self.plain = plain_fn

    def __call__(self, x, g, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm,
                 brm, agg: str = "right", *, tile: int | None = None):
        if x.device.type == "cpu":
            return self.plain(x, g, base, alpha, wf, bf, wm1, bm1, wm2, bm2,
                              wrm, brm, agg=agg)
        if x.device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {x.device}")
        if agg not in ("right", "left"):
            raise ValueError(f"agg={agg!r}: expected 'right' or 'left'")
        weights = dict(zip(_WEIGHTS, (base, alpha, wf, bf, wm1, bm1, wm2,
                                      bm2, wrm, brm)))
        n, t, v, ci, co, k, r = self._check(x, weights, g)
        lib, tile, floats = self._plan(n, t, v, ci, co, k, r, tile)
        grads = [torch.empty_like(x)] + [torch.empty_like(weights[key])
                                         for key in _WEIGHTS]
        # freed when this call returns: the caching allocator hands it out
        # again only to work queued after the kernel on the same stream
        scratch = torch.empty(floats, device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [a.data_ptr() for a in [x, g] + list(weights.values())
                + grads + [scratch]]
        err = getattr(lib, f"{self.name}_f32")(
            *ptrs, n, t, v, ci, co, k, r, int(agg == "left"), tile,
            x.device.index, stream)
        self._raise_on(lib, err)
        self.launches += BWD_LAUNCHES
        return tuple(grads)


class FusedOp(_Kernel):
    """One DSTD-GC op: CUDA kernels on the card, plain ops on the CPU,
    differentiable through :class:`_DSTDFunction`."""

    def __init__(self, mode: str, plain_fn, default_tile: int,
                 clustered: bool, bwd: FusedBwd):
        super().__init__(f"dstd_{mode}", mode, default_tile, clustered)
        self.plain = plain_fn
        self.bwd = bwd

    def __call__(self, x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                 mask=None, agg: str = "right", dtype=None, *,
                 tile: int | None = None) -> torch.Tensor:
        if mask is not None or (dtype is not None and x.device.type == "cpu"):
            return self.plain(x, base, alpha, wf, bf, wm1, bm1, wm2, bm2,
                              wrm, brm, mask, agg, dtype)
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{self.name}: unsupported device {x.device}")
        if dtype is not None:
            raise NotImplementedError(
                f"{self.name}: the CUDA kernel is float32 only; compute "
                f"dtype {dtype} is ROADMAP Queue 2 (bf16 kernels)")
        if agg not in ("right", "left"):
            raise ValueError(f"agg={agg!r}: expected 'right' or 'left'")
        alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
        args = (x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm)
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            return _DSTDFunction.apply(self, agg, tile, *args)
        return self.forward(*args, agg=agg, tile=tile)

    def forward(self, x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                agg: str = "right", tile: int | None = None) -> torch.Tensor:
        """One forward call, outside autograd."""
        if x.device.type == "cpu":
            return self.plain(x, base, alpha, wf, bf, wm1, bm1, wm2, bm2,
                              wrm, brm, None, agg)
        weights = dict(zip(_WEIGHTS, (base, alpha, wf, bf, wm1, bm1, wm2,
                                      bm2, wrm, brm)))
        n, t, v, ci, co, k, r = self._check(x, weights)
        lib, tile, _ = self._plan(n, t, v, ci, co, k, r, tile)
        out = torch.empty((n, t, v, co), device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [a.data_ptr() for a in [x] + list(weights.values()) + [out]]
        err = getattr(lib, f"{self.name}_f32")(
            *ptrs, n, t, v, ci, co, k, r, int(agg == "left"), tile,
            x.device.index, stream)
        self._raise_on(lib, err)
        self.launches += 1
        return out


class _DSTDFunction(torch.autograd.Function):
    """Forward kernel saving ``x`` and the weights; backward kernel on the
    cotangent (``jax.custom_vjp`` of ``dstdgcn_tpu/kernels/fused.py``)."""

    @staticmethod
    def forward(ctx, op, agg, tile, *args):
        ctx.op, ctx.agg = op, agg
        ctx.save_for_backward(*args)
        return op.forward(*args, agg=agg, tile=tile)

    @staticmethod
    def backward(ctx, g):
        x, *weights = ctx.saved_tensors
        grads = ctx.op.bwd(x, g.contiguous(), *weights, agg=ctx.agg)
        return (None, None, None) + tuple(grads)


dstd_spatial_bwd = FusedBwd("spatial", plain_bwd.dstd_spatial_bwd,
                            default_tile=5)
dstd_temporal_bwd = FusedBwd("temporal", plain_bwd.dstd_temporal_bwd,
                             default_tile=5)
dstd_spatial = FusedOp("spatial", plain.dstd_spatial, default_tile=5,
                       clustered=True, bwd=dstd_spatial_bwd)
dstd_temporal = FusedOp("temporal", plain.dstd_temporal, default_tile=6,
                        clustered=False, bwd=dstd_temporal_bwd)

_KERNELS = (dstd_spatial, dstd_temporal, dstd_spatial_bwd, dstd_temporal_bwd)


def launch_counts() -> Dict[str, int]:
    return {op.name: op.launches for op in _KERNELS}


def reset_launch_counts() -> None:
    for op in _KERNELS:
        op.launches = 0
