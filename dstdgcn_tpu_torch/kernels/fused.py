"""Wrappers of the whole-op DSTD-GC CUDA kernels.

``dstd_spatial`` and ``dstd_temporal`` keep the argument order of
``dstdgcn_tpu/kernels/fused.py`` (``x, base, alpha, wf, bf, wm1, bm1, wm2,
bm2, wrm, brm, mask, agg, dtype``).  On a CUDA tensor a wrapper launches
its kernel (``csrc/dstd_spatial.cu`` / ``csrc/dstd_temporal.cu``) or
raises; on a CPU tensor, or when a ``mask`` is given, it returns the plain
op of :mod:`..ops.dstd`.  Each wrapper counts its kernel launches in
``.launches`` (a plain integer; :func:`reset_launch_counts` zeroes them).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops import dstd as plain
from . import build

__all__ = ["dstd_spatial", "dstd_temporal", "FusedOp", "launch_counts",
           "reset_launch_counts", "SMEM_LIMIT"]

#: dynamic shared memory one block may use on Hopper (232,448 bytes)
SMEM_LIMIT = 227 * 1024
#: the kernels' largest output tile and cluster (csrc/dstd_common.cuh):
#: the spatial kernel runs the ceil(T / tile) blocks of a sample as one
#: thread-block cluster
MAX_TILE = 8
MAX_CLUSTER = 8
#: y-dimension grid limit: one grid row per sample
MAX_SAMPLES = 65535


class FusedOp:
    """One DSTD-GC op: CUDA kernel on the card, plain op on the CPU."""

    def __init__(self, mode: str, plain_fn, default_tile: int,
                 clustered: bool):
        self.mode = mode
        self.clustered = clustered
        self.name = f"dstd_{mode}"
        self.plain = plain_fn
        self.default_tile = default_tile
        self.launches = 0

    def __call__(self, x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                 mask=None, agg: str = "right", dtype=None, *,
                 tile: int | None = None) -> torch.Tensor:
        if mask is not None or x.device.type == "cpu":
            return self.plain(x, base, alpha, wf, bf, wm1, bm1, wm2, bm2,
                              wrm, brm, mask, agg, dtype)
        if x.device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device {x.device}")
        if dtype is not None:
            raise NotImplementedError(
                f"{self.name}: the CUDA kernel is float32 only; compute "
                f"dtype {dtype} is ROADMAP Queue 2 (bf16 kernels)")
        if agg not in ("right", "left"):
            raise ValueError(f"agg={agg!r}: expected 'right' or 'left'")
        return self._launch(x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm,
                            brm, agg, tile)

    def _check(self, x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm):
        if x.dim() != 4:
            raise ValueError(f"{self.name}: x must be (N,T,V,C), got "
                             f"{tuple(x.shape)}")
        n, t, v, ci = x.shape
        k, co, r = wf.shape[0], wf.shape[-1], wm1.shape[-1]
        ref = t if self.mode == "spatial" else v      # wrm / brm extent
        pair = v if self.mode == "spatial" else t     # base extent
        want = dict(base=(k, pair, pair), alpha=None, wf=(k, ci, co),
                    bf=(k, co), wm1=(k, ci, r), bm1=(k, r), wm2=(k, ci, r),
                    bm2=(k, r), wrm=(k, r, ref, ref), brm=(k, ref))
        args = dict(x=x, base=base, alpha=alpha, wf=wf, bf=bf, wm1=wm1,
                    bm1=bm1, wm2=wm2, bm2=bm2, wrm=wrm, brm=brm)
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
        if alpha.numel() != 1:
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

    def _launch(self, x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                agg, tile):
        n, t, v, ci, co, k, r = self._check(x, base, alpha, wf, bf, wm1,
                                            bm1, wm2, bm2, wrm, brm)
        lib = build.library(self.name)
        tile = self._tile(lib, t, v, ci, co, k, r, tile)
        out = torch.empty((n, t, v, co), device=x.device, dtype=torch.float32)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [a.data_ptr() for a in (x, base, alpha, wf, bf, wm1, bm1, wm2,
                                       bm2, wrm, brm, out)]
        err = getattr(lib, f"{self.name}_f32")(
            *ptrs, n, t, v, ci, co, k, r, int(agg == "left"), tile,
            x.device.index, stream)
        if err != 0:
            msg = lib.dstd_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"cudaError {err} ({msg})")
        self.launches += 1
        return out


dstd_spatial = FusedOp("spatial", plain.dstd_spatial, default_tile=5,
                       clustered=True)
dstd_temporal = FusedOp("temporal", plain.dstd_temporal, default_tile=6,
                        clustered=False)

_OPS = (dstd_spatial, dstd_temporal)


def launch_counts() -> Dict[str, int]:
    return {op.name: op.launches for op in _OPS}


def reset_launch_counts() -> None:
    for op in _OPS:
        op.launches = 0
