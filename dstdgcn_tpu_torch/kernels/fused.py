"""Wrappers of the DSTD-GC CUDA kernels: one op forward and backward, and
chains of ops in one launch.

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
hand-derived plain backward of :mod:`..ops.dstd_bwd`.  A ``mask`` takes the
plain op under autograd, as in the JAX package.  ``dtype=torch.bfloat16``
selects the kernels' bf16 variants (``dstd_*_bf16``): the operands of every
in-kernel contraction rounded to bf16, sums in float32, as the TPU kernels'
``dtype`` does; on the CPU their plain version is
:func:`..ops.dstd.kernel_spatial` / ``kernel_temporal`` and the plain
backward with the same ``dtype``.  ``x`` (and the cotangent) may then be
bf16: the bf16 forward kernels read it as bf16 (a float32 x is rounded to
bf16 first, as the contract rounds it), the backward kernels as float32;
the output is cast to ``dtype`` and the gradients come back in the
primals' dtypes.  Every wrapper counts its kernel launches, float32 in
``.launches`` and bf16 in ``.launches_bf16`` (plain integers;
:func:`reset_launch_counts` zeroes them); one backward call is
:data:`BWD_LAUNCHES` launches.

``dstd_chain`` and ``dstd_encoder_chain`` keep the argument structure of
their JAX counterparts (``x, blocks_or_layers, agg, dtype, nb``) and run a
whole chain of ops as one launch of ``csrc/dstd_chain.cu``, float32 or,
with ``dtype=torch.bfloat16``, the bf16 variant (``<name>_bf16``); x and
the output are float32 in both.  Their plain versions (``_chain_oracle``,
``_encoder_oracle``, built on the plain ops, with the ``dtype`` on
:func:`..ops.dstd.kernel_spatial` / ``kernel_temporal``) and
:func:`bn_affine` live here too, as in the JAX package.  The gradient of
``dstd_chain`` replays the chain at float32 whatever its ``dtype``, as the
JAX package's does.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import torch

from ..ops import dstd as plain
from ..ops import dstd_bwd as plain_bwd
from . import build

__all__ = ["dstd_spatial", "dstd_temporal", "dstd_spatial_bwd",
           "dstd_temporal_bwd", "dstd_chain", "dstd_encoder_chain",
           "bn_affine", "pack_chain", "ChainWeights", "FusedOp", "FusedBwd",
           "launch_counts", "reset_launch_counts", "SMEM_LIMIT",
           "BWD_LAUNCHES"]

#: dynamic shared memory one block may use on Hopper (232,448 bytes)
SMEM_LIMIT = 227 * 1024
#: the kernels' largest output tile and cluster (csrc/dstd_common.cuh):
#: the spatial forward kernels and the bf16 temporal one run the
#: ceil(extent / tile) blocks of a sample as one thread-block cluster
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


def _op_shapes(k, ci, co, r, ref, pair, lead=()):
    """Shapes of one op's ten weights (``lead`` prepends a layer axis;
    alpha is then one value per layer)."""
    shapes = dict(base=(k, pair, pair), wf=(k, ci, co), bf=(k, co),
                  wm1=(k, ci, r), bm1=(k, r), wm2=(k, ci, r), bm2=(k, r),
                  wrm=(k, r, ref, ref), brm=(k, ref))
    shapes = {key: tuple(lead) + s for key, s in shapes.items()}
    if lead:
        shapes["alpha"] = tuple(lead) + (1,)
    return shapes


def _check_arrays(name: str, x: torch.Tensor, arrays: Dict, want: Dict,
                  low=()):
    """Raise unless every tensor of ``arrays`` lies on x's device as a
    contiguous float32 tensor (bf16 too for the keys in ``low``, which the
    wrapper converts) that starts on a 16-byte boundary, with the shape
    ``want`` gives for its key (where it gives one)."""
    for key, arr in arrays.items():
        if not isinstance(arr, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a tensor")
        if arr.device != x.device:
            raise ValueError(f"{name}: {key} on {arr.device}, x on "
                             f"{x.device}")
        if arr.dtype != torch.float32 and not (
                key in low and arr.dtype == torch.bfloat16):
            raise TypeError(f"{name}: {key} is {arr.dtype}; the kernel "
                            "takes float32")
        if not arr.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if arr.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start on a 16-byte "
                             "boundary (float4 loads)")
        shape = want.get(key)
        if shape is not None and tuple(arr.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(arr.shape)}, "
                             f"expected {shape}")


class _Counted:
    """The launch counts of one kernel wrapper, float32 in ``.launches`` and
    bf16 in ``.launches_bf16``, and the variant a compute dtype selects."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.launches_bf16 = 0

    def _variant(self, dtype) -> str:
        """The C function suffix of a compute dtype (``f32`` or ``bf16``);
        raises for a dtype that has no kernel."""
        dtype = _compute_dtype(dtype)
        if dtype is None:
            return "f32"
        if dtype == torch.bfloat16:
            return "bf16"
        raise NotImplementedError(
            f"{self.name}: the CUDA kernels compute in float32 or with "
            f"bfloat16 contraction operands; compute dtype {dtype} has no "
            "kernel")

    def _count(self, variant: str, launches: int) -> None:
        if variant == "bf16":
            self.launches_bf16 += launches
        else:
            self.launches += launches

    def _raise_on(self, lib, err):
        if err != 0:
            msg = lib.dstd_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"cudaError {err} ({msg})")


class _Kernel(_Counted):
    """Shape checks, tile choice and the launch count of one CUDA kernel
    library (``build.SOURCES`` name ``name``); ``clustered``: the variants
    (``f32``, ``bf16``) that run a sample's blocks as one cluster."""

    def __init__(self, name: str, mode: str, default_tile: int,
                 clustered: tuple = ()):
        super().__init__(name)
        self.mode = mode
        self.default_tile = default_tile
        self.clustered = clustered
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
        want = _op_shapes(k, ci, co, r, ref, pair)
        want["g"] = (n, t, v, co)
        args = dict(x=x, **weights)
        if g is not None:
            args["g"] = g
        _check_arrays(self.name, x, args, want, low=("x", "g"))
        if weights["alpha"].numel() != 1:
            raise ValueError(f"{self.name}: alpha must hold one value")
        if n > MAX_SAMPLES:
            raise ValueError(f"{self.name}: batch {n} exceeds {MAX_SAMPLES}")
        return n, t, v, ci, co, k, r

    def _tile(self, lib, variant, t, v, ci, co, k, r, tile):
        """Largest tile <= the requested one whose block fits in shared
        memory (the variant's size, ``build.SMEM_BYTES``) and, for a
        clustered variant, whose sample fits in one cluster of
        MAX_CLUSTER blocks."""
        smem = getattr(lib, build.SMEM_BYTES[self.name, variant])
        extent = t if self.mode == "spatial" else v
        lowest = (-(-extent // MAX_CLUSTER) if variant in self.clustered
                  else 1)
        tile = min(max(tile or self.default_tile, lowest), extent, MAX_TILE)
        for size in range(tile, lowest - 1, -1):
            if smem(t, v, ci, co, k, r, size) <= SMEM_LIMIT:
                return size
        raise ValueError(
            f"{self.name}: T={t}, V={v}, {ci}->{co} channels need a tile of "
            f"{lowest}..{MAX_TILE} within {SMEM_LIMIT} bytes of shared "
            "memory")

    def _plan(self, variant, n, t, v, ci, co, k, r, tile):
        """(library, tile, scratch floats) of a variant at a call shape,
        looked up once: the tile search asks the library for shared-memory
        sizes."""
        key = (variant, n, t, v, ci, co, k, r, tile)
        plan = self._plans.get(key)
        if plan is None:
            lib = build.library(self.name)
            size = self._tile(lib, variant, t, v, ci, co, k, r, tile)
            scratch = getattr(lib, f"{self.name}_scratch_floats", None)
            floats = 0 if scratch is None else scratch(n, t, v, ci, co, k,
                                                       r, size)
            plan = self._plans[key] = (lib, size, floats)
        return plan


class FusedBwd(_Kernel):
    """Backward of one DSTD-GC op: CUDA kernel on the card, the plain
    backward of :mod:`..ops.dstd_bwd` on the CPU.  Returns the 11 gradients
    ``(dx, dbase, dalpha, dwf, dbf, dwm1, dbm1, dwm2, dbm2, dwrm, dbrm)``.
    ``f32_tile``: the float32 kernel's default tile where it differs from
    the bf16 one's (``default_tile``)."""

    def __init__(self, mode: str, plain_fn, default_tile: int,
                 f32_tile: int | None = None):
        super().__init__(f"dstd_{mode}_bwd", mode, default_tile)
        self.plain = plain_fn
        self.f32_tile = f32_tile or default_tile

    def _tile(self, lib, variant, t, v, ci, co, k, r, tile):
        """The largest tile that fits (``_Kernel._tile``); without a tile
        asked for, the smallest one with as few blocks a sample, so no
        block is left nearly empty (at CMU's 25 joints the bf16 temporal
        backward at tile 7, blocks of 7, 7, 7, 4, measured faster than at
        tile 8, blocks of 8, 8, 8, 1; PERF.md)."""
        size = super()._tile(lib, variant, t, v, ci, co, k, r, tile)
        if tile is not None:
            return size
        extent = t if self.mode == "spatial" else v
        return -(-extent // -(-extent // size))

    def __call__(self, x, g, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm,
                 brm, agg: str = "right", dtype=None, *,
                 tile: int | None = None):
        dtype = _compute_dtype(dtype)
        if x.device.type == "cpu":
            return self.plain(x, g, base, alpha, wf, bf, wm1, bm1, wm2, bm2,
                              wrm, brm, agg=agg, dtype=dtype)
        if x.device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {x.device}")
        if agg not in ("right", "left"):
            raise ValueError(f"agg={agg!r}: expected 'right' or 'left'")
        variant = self._variant(dtype)
        weights = dict(zip(_WEIGHTS, (base, alpha, wf, bf, wm1, bm1, wm2,
                                      bm2, wrm, brm)))
        n, t, v, ci, co, k, r = self._check(x, weights, g)
        x, g = x.float(), g.float()
        if tile is None and variant == "f32":
            tile = self.f32_tile
        lib, tile, floats = self._plan(variant, n, t, v, ci, co, k, r,
                                       tile)
        grads = [torch.empty_like(x)] + [torch.empty_like(weights[key])
                                         for key in _WEIGHTS]
        # freed when this call returns: the caching allocator hands it out
        # again only to work queued after the kernel on the same stream
        scratch = torch.empty(floats, device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [a.data_ptr() for a in [x, g] + list(weights.values())
                + grads + [scratch]]
        err = getattr(lib, f"{self.name}_{variant}")(
            *ptrs, n, t, v, ci, co, k, r, int(agg == "left"), tile,
            x.device.index, stream)
        self._raise_on(lib, err)
        self._count(variant, BWD_LAUNCHES)
        return tuple(grads)


class FusedOp(_Kernel):
    """One DSTD-GC op: CUDA kernels on the card, plain ops on the CPU,
    differentiable through :class:`_DSTDFunction`.  ``f32_tile``: the
    float32 kernel's default tile where it differs from the bf16 one's
    (``default_tile``)."""

    def __init__(self, mode: str, plain_fn, kernel_fn, default_tile: int,
                 clustered: tuple, bwd: FusedBwd,
                 f32_tile: int | None = None):
        super().__init__(f"dstd_{mode}", mode, default_tile, clustered)
        self.plain = plain_fn
        self.kernel_plain = kernel_fn
        self.bwd = bwd
        self.f32_tile = f32_tile or default_tile

    def __call__(self, x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                 mask=None, agg: str = "right", dtype=None, *,
                 tile: int | None = None) -> torch.Tensor:
        if mask is not None:
            return self.plain(x, base, alpha, wf, bf, wm1, bm1, wm2, bm2,
                              wrm, brm, mask, agg, dtype)
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{self.name}: unsupported device {x.device}")
        if agg not in ("right", "left"):
            raise ValueError(f"agg={agg!r}: expected 'right' or 'left'")
        dtype = _compute_dtype(dtype)
        if x.device.type == "cuda":
            self._variant(dtype)
        alpha = torch.as_tensor(alpha, device=x.device, dtype=torch
                                .promote_types(x.dtype, torch.float32))
        args = (x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm)
        if torch.is_grad_enabled() and any(a.requires_grad for a in args):
            return _DSTDFunction.apply(self, agg, dtype, tile, *args)
        return self.forward(*args, agg=agg, dtype=dtype, tile=tile)

    def forward(self, x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                agg: str = "right", dtype=None,
                tile: int | None = None) -> torch.Tensor:
        """One forward call, outside autograd."""
        if x.device.type == "cpu":
            if dtype is None:
                return self.plain(x, base, alpha, wf, bf, wm1, bm1, wm2, bm2,
                                  wrm, brm, None, agg)
            return self.kernel_plain(x, base, alpha, wf, bf, wm1, bm1, wm2,
                                     bm2, wrm, brm, agg, dtype).to(dtype)
        out = self.launch(x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm,
                          brm, agg=agg, dtype=dtype, tile=tile)
        return out if dtype is None else out.to(dtype)

    def launch(self, x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
               agg: str = "right", dtype=None,
               tile: int | None = None) -> torch.Tensor:
        """One kernel launch on the card, outside autograd: the float32
        variant, or with ``dtype=torch.bfloat16`` the bf16 one; returns the
        kernel's float32 output, before :meth:`forward` casts it to
        ``dtype`` (the plain version of that output is ``kernel_plain``)."""
        variant = self._variant(dtype)
        weights = dict(zip(_WEIGHTS, (base, alpha, wf, bf, wm1, bm1, wm2,
                                      bm2, wrm, brm)))
        n, t, v, ci, co, k, r = self._check(x, weights)
        # the bf16 kernel reads x as bf16 (the contract's rounding of it,
        # a no-op for the model's bf16 activations), the float32 one as
        # float32
        x = x.to(torch.bfloat16) if variant == "bf16" else x.float()
        if tile is None and variant == "f32":
            tile = self.f32_tile
        lib, tile, _ = self._plan(variant, n, t, v, ci, co, k, r, tile)
        out = torch.empty((n, t, v, co), device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [a.data_ptr() for a in [x] + list(weights.values()) + [out]]
        err = getattr(lib, f"{self.name}_{variant}")(
            *ptrs, n, t, v, ci, co, k, r, int(agg == "left"), tile,
            x.device.index, stream)
        self._raise_on(lib, err)
        self._count(variant, 1)
        return out


def _compute_dtype(dtype):
    """None for float32 compute (``None`` or ``torch.float32``), else the
    torch dtype the contraction operands are rounded to."""
    return None if dtype in (None, torch.float32) else dtype


class _DSTDFunction(torch.autograd.Function):
    """Forward kernel saving ``x`` and the weights; backward kernel on the
    cotangent (``jax.custom_vjp`` of ``dstdgcn_tpu/kernels/fused.py``),
    the gradients in the primals' dtypes."""

    @staticmethod
    def forward(ctx, op, agg, dtype, tile, *args):
        ctx.op, ctx.agg, ctx.dtype = op, agg, dtype
        ctx.save_for_backward(*args)
        return op.forward(*args, agg=agg, dtype=dtype, tile=tile)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        grads = ctx.op.bwd(saved[0], g.contiguous(), *saved[1:],
                           agg=ctx.agg, dtype=ctx.dtype)
        return (None,) * 4 + tuple(gr.to(a.dtype)
                                   for gr, a in zip(grads, saved))


# the bf16 backward at up to 8 output indices a block (evened out: 7 at
# T = 35, 8 at H36M's V = 22, 7 at CMU's 25): its bf16 pass 2 leaves room
# for them in one block an SM (175,216 and 213,296 B at H36M's shape,
# 64->64), and fewer blocks a sample recompute fewer scores; at H36M's
# shape and N = 128 the spatial and temporal backward measured 1.17x and
# 1.24x faster than at tile 5, and faster than two blocks an SM at tiles 3
# and 4 (PERF.md); the tile search steps down where a block does not fit
dstd_spatial_bwd = FusedBwd("spatial", plain_bwd.dstd_spatial_bwd,
                            default_tile=8, f32_tile=5)
# the float32 temporal backward at tile 4: 6 blocks a sample (1.45 waves on
# the H100's 132 SMs at N = 32) measured faster than 5 and 6 (PERF.md)
dstd_temporal_bwd = FusedBwd("temporal", plain_bwd.dstd_temporal_bwd,
                             default_tile=8, f32_tile=4)
dstd_spatial = FusedOp("spatial", plain.dstd_spatial, plain.kernel_spatial,
                       default_tile=5, clustered=("f32", "bf16"),
                       bwd=dstd_spatial_bwd)
# the temporal forward runs a sample's blocks as one cluster in both
# dtypes; the float32 one at tile 4: 97,088 B a block at 64->64, a cluster
# of 6, two blocks an SM and one wave at N = 32 (on 3xTF32 products tile 6
# at one block an SM measured 1.77x slower, tiles 3 and 5 1.46x and 1.49x;
# PERF.md)
dstd_temporal = FusedOp("temporal", plain.dstd_temporal,
                        plain.kernel_temporal, default_tile=6,
                        clustered=("f32", "bf16"), bwd=dstd_temporal_bwd,
                        f32_tile=4)

# -- chains of ops in one launch ------------------------------------------


def bn_affine(scale, bias, mean, var, eps: float = 1e-5) -> torch.Tensor:
    """Fold eval-mode JointBatchNorm parameters ((V, C) each) into a
    (2, V, C) multiply-add: ``x * aff[0] + aff[1]``."""
    inv = scale * torch.rsqrt(var + eps)
    return torch.stack([inv, bias - mean * inv])


def _plain_op(mode, x, args, agg, dtype):
    """One plain op of a chain; with a ``dtype`` the kernels' rounding
    (:func:`..ops.dstd.kernel_spatial`), the output kept in float32 as the
    chain kernels keep activations."""
    if dtype is None:
        return getattr(plain, f"dstd_{mode}")(x, *args, agg=agg)
    return getattr(plain, f"kernel_{mode}")(x, *args, agg=agg,
                                            dtype=_compute_dtype(dtype))


def _chain_oracle(x, blocks, agg, dtype=None):
    """Plain version of :data:`dstd_chain`: the ops one by one."""
    for sp, tm in blocks:
        x = _plain_op("spatial", x, sp, agg, dtype)
        x = _plain_op("temporal", x, tm, agg, dtype)
    return x


def _encoder_oracle(x, layers, agg, dtype=None):
    """Plain version of :data:`dstd_encoder_chain`, in the JAX package's
    order: the first affine before the residual, the second after it, both
    residuals from the layer input."""
    for sp, tm, aff1, aff2, pa in layers:
        y = _plain_op("spatial", x, sp, agg, dtype)
        y = y * aff1[0] + aff1[1] + x
        y = torch.where(y >= 0, y, pa[0] * y)
        z = _plain_op("temporal", y, tm, agg, dtype) + x
        z = z * aff2[0] + aff2[1]
        x = torch.where(z >= 0, z, pa[1] * z)
    return x


class ChainWeights(NamedTuple):
    """The layers of a chain in the two forms its wrapper reads: as given
    (the plain version and the backward replay use these) and with each
    weight stacked over the layers (the kernel reads these)."""
    layers: tuple
    spatial: tuple    # the ten spatial weights, each (L, ...)
    temporal: tuple   # the ten temporal weights, each (L, ...)
    extras: tuple     # encoder: aff1, aff2 (L, 2, V, C), prelu (L, 2)


def _as_layers(layers, device) -> tuple:
    """Layers (or blocks) as tuples of tensors; a number (an alpha, a PReLU
    slope) becomes a float32 tensor on ``device``."""
    def leaf(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device) \
            if not isinstance(a, torch.Tensor) else a

    return tuple(tuple(tuple(leaf(a) for a in part)
                       if isinstance(part, (tuple, list)) else leaf(part)
                       for part in layer) for layer in layers)


def pack_chain(layers) -> ChainWeights:
    """Stack the weights of a chain's ``(spatial, temporal)`` blocks or an
    encoder's ``(spatial, temporal, aff1, aff2, prelu)`` layers for the
    kernel.  Pack once where the weights stay fixed (an evaluation sweep)
    and hand the result to the wrapper in place of the list."""
    if not layers:
        raise ValueError("a chain needs at least one layer")
    width = len(layers[0])
    if width not in (2, 5) or any(len(layer) != width for layer in layers):
        raise ValueError("chain layers are (spatial, temporal) blocks or "
                         "(spatial, temporal, aff1, aff2, prelu) layers")
    layers = _as_layers(layers, layers[0][0][2].device)   # the spatial wf

    def stack(arrs, shape=None):
        arrs = [a.float() if shape is None else a.float().reshape(shape)
                for a in arrs]
        shapes = {tuple(a.shape) for a in arrs}
        if len(shapes) > 1:
            raise ValueError(f"chain layers differ in shape: {shapes}")
        return torch.stack(arrs).contiguous()

    def op(i):
        return tuple(stack([layer[i][j] for layer in layers],
                           (1,) if j == 1 else None) for j in range(10))

    extras = () if width == 2 else (
        stack([layer[2] for layer in layers]),
        stack([layer[3] for layer in layers]),
        stack([layer[4] for layer in layers], (2,)))
    return ChainWeights(layers, op(0), op(1), extras)


def _flat(layers) -> list:
    return [a for layer in layers for part in layer
            for a in (part if isinstance(part, tuple) else (part,))]


class ChainOp(_Counted):
    """Checks, tile and launch counts of one entry of the chain library
    (``csrc/dstd_chain.cu``): ``dstd_chain`` or ``dstd_encoder_chain``, each
    with a float32 and a bf16 variant."""

    def __init__(self, name: str, encoder: bool):
        super().__init__(name)
        self.encoder = encoder
        self._tiles: Dict[tuple, int] = {}

    def _check(self, x, w: ChainWeights):
        if x.dim() != 4:
            raise ValueError(f"{self.name}: x must be (N,T,V,C), got "
                             f"{tuple(x.shape)}")
        n, t, v, c = x.shape
        layers, ks, kt = len(w.layers), w.spatial[2].shape[1], \
            w.temporal[2].shape[1]
        r = w.spatial[4].shape[-1]
        lead = (layers,)
        arrays, want = {"x": x}, {}
        for mode, ws, k, ref, pair in (("spatial", w.spatial, ks, t, v),
                                       ("temporal", w.temporal, kt, v, t)):
            shapes = _op_shapes(k, c, c, r, ref, pair, lead)
            for key, arr in zip(_WEIGHTS, ws):
                arrays[f"{mode} {key}"] = arr
                want[f"{mode} {key}"] = shapes[key]
        if self.encoder:
            if len(w.extras) != 3:
                raise ValueError(f"{self.name}: layers need aff1, aff2 and "
                                 "the PReLU slopes")
            for key, arr, shape in zip(("aff1", "aff2", "prelu"), w.extras,
                                       ((layers, 2, v, c), (layers, 2, v, c),
                                        (layers, 2))):
                arrays[key], want[key] = arr, shape
        _check_arrays(self.name, x, arrays, want)
        if n > MAX_SAMPLES:
            raise ValueError(f"{self.name}: batch {n} exceeds {MAX_SAMPLES}")
        return n, t, v, c, layers, ks, kt, r

    def _tile(self, lib, variant, t, v, c, ks, kt, r):
        """The smallest tile that fits a sample's ops in one cluster of
        MAX_CLUSTER blocks, if its block fits in shared memory (the
        variant's size, ``build.SMEM_BYTES``)."""
        key = (variant, t, v, c, ks, kt, r)
        tile = self._tiles.get(key)
        if tile is None:
            tile = -(-max(t, v) // MAX_CLUSTER)
            smem = getattr(lib, build.SMEM_BYTES[self.name, variant])
            if tile > MAX_TILE or smem(t, v, c, ks, kt, r,
                                       tile) > SMEM_LIMIT:
                raise ValueError(
                    f"{self.name}: T={t}, V={v}, C={c} do not fit one "
                    f"cluster of {MAX_CLUSTER} blocks of tile <= {MAX_TILE} "
                    f"within {SMEM_LIMIT} bytes of shared memory")
            self._tiles[key] = tile
        return tile

    def launch(self, x, w: ChainWeights, agg: str,
               dtype=None) -> torch.Tensor:
        """One kernel launch on the card, outside autograd: the float32
        variant, or with ``dtype=torch.bfloat16`` the bf16 one; x and the
        output are float32 in both."""
        variant = self._variant(dtype)
        n, t, v, c, layers, ks, kt, r = self._check(x, w)
        lib = build.library("dstd_chain")
        tile = self._tile(lib, variant, t, v, c, ks, kt, r)
        out = torch.empty_like(x)
        # mid and ping activations; freed when this call returns, handed out
        # again only to work queued after the kernel on the same stream
        scratch = torch.empty(2 * x.numel(), device=x.device,
                              dtype=torch.float32)
        weights = (ctypes.c_void_p * 20)(
            *[a.data_ptr() for a in w.spatial + w.temporal])
        ints = (n, t, v, c, layers, ks, kt, r, int(agg == "left"), tile,
                x.device.index)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        extras = [a.data_ptr() for a in w.extras] if self.encoder else []
        err = getattr(lib, f"{self.name}_{variant}")(
            x.data_ptr(), weights, *extras, out.data_ptr(),
            scratch.data_ptr(), *ints, stream)
        self._raise_on(lib, err)
        self._count(variant, 1)
        return out

    def _device(self, x, agg, dtype):
        """Raise for an aggregation, a device or a compute dtype that the
        chain has no kernel for (on the CPU too, where the plain version
        computes the kernel's contract)."""
        if agg not in ("right", "left"):
            raise ValueError(f"agg={agg!r}: expected 'right' or 'left'")
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{self.name}: unsupported device {x.device}")
        self._variant(dtype)


class DSTDChain(ChainOp):
    """B alternating (spatial, temporal) DSTD-GC ops in one launch.

    ``dstd_chain(x, blocks, agg, dtype, nb)``: ``blocks`` holds ``(spatial,
    temporal)`` pairs of 10-tuples in the argument order of
    :data:`dstd_spatial` (or is their :func:`pack_chain`); channels stay
    ``C`` throughout.  ``dtype=torch.bfloat16`` launches the bf16 variant
    (``dstd_chain_bf16``); the output is float32 either way, as in the JAX
    package.  Differentiable: the backward replays the chain at float32,
    whatever ``dtype`` the forward took (``_chain_bwd`` of the JAX package
    takes the VJP of its float32 oracle), under autograd through
    :data:`dstd_spatial` / :data:`dstd_temporal`, which on the card runs the
    float32 forward and backward kernels of each op, on the CPU the plain
    ops and the plain backward.  ``nb`` (samples per grid program on the
    TPU) has no meaning here and is ignored.
    """

    def __call__(self, x, blocks, agg: str = "right", dtype=None, nb=None):
        del nb
        self._device(x, agg, dtype)
        packed = blocks if isinstance(blocks, ChainWeights) else None
        layers = _as_layers(packed.layers if packed else blocks, x.device)
        flat = _flat(layers)
        if torch.is_grad_enabled() and any(a.requires_grad
                                           for a in [x] + flat):
            return _ChainFunction.apply(self, agg, dtype, packed, x, *flat)
        return self.forward(x, layers, agg, dtype, packed)

    def forward(self, x, layers, agg, dtype=None, packed=None):
        if x.device.type == "cpu":
            return _chain_oracle(x, layers, agg, dtype)
        return self.launch(x, packed or pack_chain(layers), agg, dtype)


def _blocks(flat) -> tuple:
    """Inverse of :func:`_flat` for (spatial, temporal) blocks."""
    return tuple((tuple(flat[i:i + 10]), tuple(flat[i + 10:i + 20]))
                 for i in range(0, len(flat), 20))


class _ChainFunction(torch.autograd.Function):
    """Chain kernel forward at its compute dtype; backward by replaying the
    ops at float32 under autograd (``_chain_bwd`` of the JAX package, the
    VJP of the float32 oracle at the saved ``x``)."""

    @staticmethod
    def forward(ctx, op, agg, dtype, packed, x, *flat):
        ctx.agg = agg
        ctx.save_for_backward(x, *flat)
        return op.forward(x, _blocks(flat), agg, dtype, packed)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        inputs = [a.detach().requires_grad_(need)
                  for a, need in zip(saved, ctx.needs_input_grad[4:])]
        with torch.enable_grad():
            y = inputs[0]
            for sp, tm in _blocks(inputs[1:]):
                y = dstd_spatial(y, *sp, None, ctx.agg)
                y = dstd_temporal(y, *tm, None, ctx.agg)
        wanted = [a for a in inputs if a.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, g))
        return (None,) * 4 + tuple(next(grads) if a.requires_grad else None
                                   for a in inputs)


class EncoderChain(ChainOp):
    """L encoder layers of the DSTD-GCN in one launch, eval mode.

    ``dstd_encoder_chain(x, layers, agg, dtype, nb)``: ``layers`` holds
    ``(spatial, temporal, aff1, aff2, prelu)`` per layer, the 10-tuples of
    the two ops, the folded eval BatchNorms (:func:`bn_affine`; aff1 the
    block's, aff2 the model's) and the two PReLU slopes ``(2,)``, or is
    their :func:`pack_chain`.  ``dtype=torch.bfloat16`` launches the bf16
    variant (``dstd_encoder_chain_bf16``: bf16 contraction operands, the
    epilogues in float32); the output is float32 either way.  No gradient,
    as in the JAX package: a call that would need one raises.  ``nb`` is
    ignored.
    """

    def __call__(self, x, layers, agg: str = "right", dtype=None, nb=None):
        del nb
        self._device(x, agg, dtype)
        packed = layers if isinstance(layers, ChainWeights) else None
        given = packed.layers if packed else layers
        tensors = [x] + [a for a in _flat(given)
                         if isinstance(a, torch.Tensor)]
        if packed:
            tensors += list(packed.spatial + packed.temporal + packed.extras)
        if torch.is_grad_enabled() and any(a.requires_grad for a in tensors):
            raise RuntimeError(
                f"{self.name} is inference-only and has no gradient; call "
                "it under torch.no_grad() or torch.inference_mode()")
        if x.device.type == "cpu":
            return _encoder_oracle(x, _as_layers(given, x.device), agg, dtype)
        return self.launch(x, packed or pack_chain(layers), agg, dtype)


dstd_chain = DSTDChain("dstd_chain", encoder=False)
dstd_encoder_chain = EncoderChain("dstd_encoder_chain", encoder=True)

_KERNELS = (dstd_spatial, dstd_temporal, dstd_spatial_bwd, dstd_temporal_bwd,
            dstd_chain, dstd_encoder_chain)


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last reset: the float32 kernels
    under their names, the bf16 variants as ``<name>_bf16``."""
    counts = {op.name: op.launches for op in _KERNELS}
    counts.update({f"{op.name}_bf16": op.launches_bf16 for op in _KERNELS})
    return counts


def reset_launch_counts() -> None:
    for op in _KERNELS:
        op.launches = op.launches_bf16 = 0
