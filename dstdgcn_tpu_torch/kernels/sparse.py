"""Blocked sparse SpMM / SDDMM for large graphs: the general message-passing
op surface of ``dstdgcn_tpu/kernels/sparse.py``, with its names and
signatures.

The (V x Vj) adjacency is tiled into ``block x block`` blocks and only the
*active* blocks of a sparsity pattern are read or computed; the pattern is
a row-major (rows, cols) block list from :func:`active_blocks`, which gives
every block row at least one block so each output block is written.

Ops:
  * ``block_spmm``        out[n,i,c] = sum_j A[n,i,j] x[n,j,c]
  * ``block_sddmm``       S[n,i,j]   = sum_r w[r] tanh(q[n,i,r]-k[n,j,r]),
                          active blocks only (inactive blocks unwritten)
  * ``block_sddmm_spmm``  out = S @ x fused: the score block is made and
                          consumed on chip, never written to memory.

On a CUDA tensor each op launches its kernel (``csrc/block_sparse.cu``) or
raises; on a CPU tensor it runs its plain version, the masked dense form
(``*_dense`` with the pattern's element mask).  ``block_spmm`` and
``block_sddmm_spmm`` are differentiable, with the JAX package's backward:
the masked dense products for ``block_spmm``, autograd through the masked
dense oracle for ``block_sddmm_spmm`` (exact gradients, O(V^2) memory).
Where the adjacency of ``block_spmm`` needs no gradient (a constant
support), its ``d_x = (adj * m)^T g`` is one more ``block_spmm`` call on
the transposed pattern (:meth:`BlockPattern.transposed`), against the
masked transposed adjacency ``adj_t``: a caller with a constant adjacency
builds it once and passes it, else the backward builds it.
``block_sddmm`` has no gradient in the JAX package and raises on inputs that
need one.  The per-pattern state (the checked block list, its CSR row
pointer, the device copies of rows / cols and the element mask) is built
once per ``(rows, cols, block, V, Vj)`` and cached; a call copies nothing
from the host to the card.  Every op counts its kernel launches in
``.launches`` (:func:`launch_counts`, :func:`reset_launch_counts`).
Each ``block_spmm`` launch, of either direction, runs inside the program
span ``sparse.spmm`` (:func:`..utils.profiling.span`).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils import profiling
from . import build
from .fused import MAX_SAMPLES, _check_arrays

__all__ = [
    "active_blocks", "block_spmm", "block_sddmm", "block_sddmm_spmm",
    "spmm_dense", "sddmm_dense", "sddmm_spmm_dense", "available",
    "BlockPattern", "pattern", "launch_counts", "reset_launch_counts",
    "MAX_R",
]

LIBRARY = "block_sparse"
#: largest R the SDDMM kernels take (their q / k slices in shared memory)
MAX_R = 32


def available() -> bool:
    """True when the kernels can run: a CUDA device is present."""
    return torch.cuda.is_available()


# ---------------------------------------------------------------------------
# sparsity pattern
# ---------------------------------------------------------------------------

def active_blocks(mask: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(BI, BJ) bool block mask -> (rows, cols) int32 lists, row-major.

    Every row is given at least one block (its diagonal, or the last column
    for a row past the last column of a non-square mask) so each output
    block row is written.
    """
    mask = np.asarray(mask, bool).copy()
    bi, bj = mask.shape
    for i in range(bi):
        if not mask[i].any():
            mask[i, min(i, bj - 1)] = True
    rows, cols = np.nonzero(mask)
    return rows.astype(np.int32), cols.astype(np.int32)


def _pattern_mask(rows: np.ndarray, cols: np.ndarray, bi: int, bj: int,
                  block: int) -> np.ndarray:
    m = np.zeros((bi, bj), np.float32)
    m[rows, cols] = 1.0
    return np.kron(m, np.ones((block, block), np.float32))


class BlockPattern:
    """A checked block list and the state the kernels read: the CSR row
    pointer over block rows, and per device the copies of ``row_ptr``,
    ``rows`` and ``cols`` and the (V, Vj) float32 element mask (built at
    first use on that device)."""

    def __init__(self, rows: np.ndarray, cols: np.ndarray, block: int,
                 v: int, vj: int):
        if block < 1:
            raise ValueError(f"block must be positive, got {block}")
        if v % block or vj % block:
            raise ValueError(f"the adjacency is {v} x {vj}: both must be "
                             f"multiples of block={block}")
        if rows.ndim != 1 or rows.shape != cols.shape or not len(rows):
            raise ValueError("rows and cols must be equal-length, non-empty "
                             "1-D block lists")
        bi, bj = v // block, vj // block
        if rows.min() < 0 or rows.max() >= bi or cols.min() < 0 \
                or cols.max() >= bj:
            raise ValueError(f"block indices out of range for a {bi} x {bj} "
                             "block grid")
        if np.any(np.diff(rows) < 0):
            raise ValueError("rows must be sorted (row-major block list, as "
                             "active_blocks gives it)")
        missing = np.setdiff1d(np.arange(bi), rows)
        if len(missing):
            raise ValueError(f"block rows {missing[:8].tolist()} have no "
                             "active block: every row needs one "
                             "(active_blocks adds it)")
        if len(np.unique(rows.astype(np.int64) * bj + cols)) != len(rows):
            raise ValueError("a (row, col) block is listed twice")
        self.rows, self.cols = rows.copy(), cols.copy()
        self.block, self.v, self.vj = block, v, vj
        self.row_ptr = np.searchsorted(rows, np.arange(bi + 1)).astype(
            np.int32)
        self._device: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        self._t = None

    @property
    def num_blocks(self) -> int:
        """The count of active blocks."""
        return len(self.rows)

    def transposed(self) -> "BlockPattern":
        """The cached pattern of the transposed blocks (Vj x V), every
        block row given a block as :func:`active_blocks` gives it."""
        if self._t is None:
            mask = np.zeros((self.vj // self.block, self.v // self.block),
                            bool)
            mask[self.cols, self.rows] = True
            rows, cols = active_blocks(mask)
            self._t = pattern(rows, cols, self.block, self.vj, self.v)
        return self._t

    def _state(self, device: torch.device) -> Dict[str, torch.Tensor]:
        state = self._device.get(device)
        if state is None:
            state = self._device[device] = {
                key: torch.from_numpy(arr).to(device)
                for key, arr in (("row_ptr", self.row_ptr),
                                 ("rows", self.rows), ("cols", self.cols))}
        return state

    def csr(self, device: torch.device):
        """(row_ptr, rows, cols) int32 tensors on ``device``."""
        state = self._state(device)
        return state["row_ptr"], state["rows"], state["cols"]

    def mask(self, device: torch.device) -> torch.Tensor:
        """(V, Vj) float32 element mask: 1 on active blocks, 0 elsewhere."""
        state = self._state(device)
        if "mask" not in state:
            bm = torch.zeros((self.v // self.block, self.vj // self.block),
                             dtype=torch.float32, device=device)
            bm[state["rows"].long(), state["cols"].long()] = 1.0
            state["mask"] = bm.repeat_interleave(self.block, 0) \
                .repeat_interleave(self.block, 1)
        return state["mask"]


@functools.lru_cache(maxsize=16)
def _cached_pattern(rows_b: bytes, cols_b: bytes, block: int, v: int,
                    vj: int) -> BlockPattern:
    return BlockPattern(np.frombuffer(rows_b, np.int32),
                        np.frombuffer(cols_b, np.int32), block, v, vj)


def pattern(rows, cols, block: int, v: int, vj: int) -> BlockPattern:
    """The cached, checked :class:`BlockPattern` of a block list."""
    rows = np.ascontiguousarray(rows, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    return _cached_pattern(rows.tobytes(), cols.tobytes(), int(block),
                           int(v), int(vj))


# ---------------------------------------------------------------------------
# plain versions (dense oracles)
# ---------------------------------------------------------------------------

def spmm_dense(adj, x):
    """out[n,i,c] = sum_j adj[n,i,j] * x[n,j,c]."""
    return torch.einsum("nij,njc->nic", adj, x)


def sddmm_dense(q, k, w, mask=None):
    """S[n,i,j] = sum_r w[r] * tanh(q[n,i,r] - k[n,j,r]) (masked)."""
    s = torch.tanh(q[:, :, None, :] - k[:, None, :, :])
    s = torch.einsum("nijr,r->nij", s, w)
    if mask is not None:
        s = s * mask
    return s


def sddmm_spmm_dense(q, k, w, x, mask=None):
    return spmm_dense(sddmm_dense(q, k, w, mask), x)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_cuda(name: str, tensors: Dict[str, torch.Tensor]):
    """Raise unless every tensor lies on the first one's device as a
    contiguous float32 tensor starting on a 16-byte boundary."""
    _check_arrays(name, next(iter(tensors.values())), tensors, {})


def _device_of(name: str, *tensors) -> torch.device:
    device = tensors[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


class _SparseKernel:
    """Launch count and error check of one entry of the block-sparse
    library."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def _launch(self, *args):
        lib = build.library(LIBRARY)
        err = getattr(lib, f"{self.name}_f32")(*args)
        if err != 0:
            msg = lib.dstd_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"cudaError {err} ({msg})")
        self.launches += 1


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check_samples(name: str, n: int):
    if n > MAX_SAMPLES:
        raise ValueError(f"{name}: batch {n} exceeds {MAX_SAMPLES}")


class BlockSpmm(_SparseKernel):
    """``block_spmm(adj, x, rows, cols, block=128, adj_t=None)``: adj
    (N, V, Vj), x (N, Vj, C) -> (N, V, C), summing the active blocks of adj
    only.  ``adj_t``, for a constant adj: ``(adj * m)^T`` (N, Vj, V),
    contiguous, which ``d_x`` reads on the transposed pattern (built by
    the backward where it is not given)."""

    def __call__(self, adj, x, rows, cols, block: int = 128, adj_t=None):
        if adj.dim() != 3 or x.dim() != 3 or adj.shape[0] != x.shape[0] \
                or adj.shape[2] != x.shape[1]:
            raise ValueError(f"{self.name}: adj (N,V,Vj) and x (N,Vj,C) "
                             f"expected, got {tuple(adj.shape)} and "
                             f"{tuple(x.shape)}")
        pat = pattern(rows, cols, block, adj.shape[1], adj.shape[2])
        _device_of(self.name, adj, x)
        if _wants_grad(adj, x):
            return _SpmmFunction.apply(self, pat, adj, x, adj_t)
        return self.forward(pat, adj, x)

    def forward(self, pat: BlockPattern, adj, x) -> torch.Tensor:
        """One call, outside autograd (either direction's)."""
        with profiling.span("sparse.spmm"):
            return self._call(pat, adj, x)

    def _call(self, pat: BlockPattern, adj, x) -> torch.Tensor:
        if adj.device.type == "cpu":
            return spmm_dense(adj * pat.mask(adj.device), x)
        _check_cuda(self.name, dict(adj=adj, x=x))
        if pat.block % 4:
            raise ValueError(f"{self.name}: the kernel reads adj in float4 "
                             f"runs; block={pat.block} must be a multiple "
                             "of 4")
        n, v, vj = adj.shape
        c = x.shape[2]
        _check_samples(self.name, n)
        out = torch.empty((n, v, c), device=adj.device, dtype=torch.float32)
        if n and c:
            row_ptr, _, cols = pat.csr(adj.device)
            self._launch(adj.data_ptr(), x.data_ptr(), row_ptr.data_ptr(),
                         cols.data_ptr(), out.data_ptr(), n, v, vj, c,
                         pat.block, adj.device.index,
                         torch.cuda.current_stream(adj.device).cuda_stream)
        return out


class _SpmmFunction(torch.autograd.Function):
    """Kernel forward; the backward d_adj = (g x^T) * m, d_x = (adj * m)^T
    g: where adj needs a gradient both as the JAX package's masked dense
    products, else d_x as the kernel on the transposed pattern against
    ``adj_t`` (the caller's, or built here)."""

    @staticmethod
    def forward(ctx, op, pat, adj, x, adj_t):
        ctx.op, ctx.pat = op, pat
        ctx.save_for_backward(adj, x, adj_t)
        return op.forward(pat, adj, x)

    @staticmethod
    def backward(ctx, g):
        adj, x, adj_t = ctx.saved_tensors
        pat = ctx.pat
        d_adj = d_x = None
        if ctx.needs_input_grad[2]:
            m = pat.mask(adj.device)
            d_adj = torch.bmm(g, x.transpose(1, 2)) * m
            if ctx.needs_input_grad[3]:
                d_x = torch.bmm((adj * m).transpose(1, 2), g)
        elif ctx.needs_input_grad[3]:
            if adj_t is None:
                adj_t = (adj * pat.mask(adj.device)).transpose(1, 2) \
                    .contiguous()
            d_x = ctx.op.forward(pat.transposed(), adj_t, g.contiguous())
        return None, None, d_adj, d_x, None


def _check_qkw(name: str, q, k, w):
    if q.dim() != 3 or k.shape != q.shape or w.shape != (q.shape[2],):
        raise ValueError(f"{name}: q, k (N,V,R) and w (R,) expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(w.shape)}")


def _check_r(name: str, r: int):
    if not 1 <= r <= MAX_R:
        raise ValueError(f"{name}: R={r}; the kernel takes 1..{MAX_R}")


class BlockSddmm(_SparseKernel):
    """``block_sddmm(q, k, w, rows, cols, block=128)``: q, k (N, V, R), w
    (R,) -> (N, V, V) scores on the active blocks; inactive blocks are
    undefined (uninitialised memory on the card).  No gradient."""

    def __call__(self, q, k, w, rows, cols, block: int = 128):
        _check_qkw(self.name, q, k, w)
        if _wants_grad(q, k, w):
            raise RuntimeError(
                f"{self.name} has no gradient (the JAX package defines "
                "none); call it under torch.no_grad(), or use "
                "block_sddmm_spmm, which has one")
        n, v, r = q.shape
        pat = pattern(rows, cols, block, v, v)
        device = _device_of(self.name, q, k, w)
        if device.type == "cpu":
            return sddmm_dense(q, k, w, pat.mask(device))
        _check_cuda(self.name, dict(q=q, k=k, w=w))
        _check_r(self.name, r)
        _check_samples(self.name, n)
        out = torch.empty((n, v, v), device=device, dtype=torch.float32)
        if n:
            _, rows_d, cols_d = pat.csr(device)
            self._launch(q.data_ptr(), k.data_ptr(), w.data_ptr(),
                         rows_d.data_ptr(), cols_d.data_ptr(),
                         out.data_ptr(), n, v, r, pat.block, pat.num_blocks,
                         device.index,
                         torch.cuda.current_stream(device).cuda_stream)
        return out


class BlockSddmmSpmm(_SparseKernel):
    """``block_sddmm_spmm(q, k, w, x, rows, cols, block=128)``: q, k
    (N, V, R), w (R,), x (N, V, C) -> (N, V, C) = S @ x over the active
    blocks, the scores made and consumed on chip."""

    def __call__(self, q, k, w, x, rows, cols, block: int = 128):
        _check_qkw(self.name, q, k, w)
        if x.dim() != 3 or x.shape[:2] != q.shape[:2]:
            raise ValueError(f"{self.name}: x (N,V,C) expected beside q "
                             f"{tuple(q.shape)}, got {tuple(x.shape)}")
        pat = pattern(rows, cols, block, q.shape[1], q.shape[1])
        _device_of(self.name, q, k, w, x)
        if _wants_grad(q, k, w, x):
            return _SddmmSpmmFunction.apply(self, pat, q, k, w, x)
        return self.forward(pat, q, k, w, x)

    def forward(self, pat: BlockPattern, q, k, w, x) -> torch.Tensor:
        """One forward call, outside autograd."""
        if q.device.type == "cpu":
            return sddmm_spmm_dense(q, k, w, x, pat.mask(q.device))
        _check_cuda(self.name, dict(q=q, k=k, w=w, x=x))
        n, v, r = q.shape
        c = x.shape[2]
        _check_r(self.name, r)
        _check_samples(self.name, n)
        out = torch.empty((n, v, c), device=q.device, dtype=torch.float32)
        if n and c:
            row_ptr, _, cols = pat.csr(q.device)
            self._launch(q.data_ptr(), k.data_ptr(), w.data_ptr(),
                         x.data_ptr(), row_ptr.data_ptr(), cols.data_ptr(),
                         out.data_ptr(), n, v, r, c, pat.block,
                         q.device.index,
                         torch.cuda.current_stream(q.device).cuda_stream)
        return out


class _SddmmSpmmFunction(torch.autograd.Function):
    """Kernel forward; backward by autograd through the masked dense oracle
    (the JAX package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, op, pat, q, k, w, x):
        ctx.pat = pat
        ctx.save_for_backward(q, k, w, x)
        return op.forward(pat, q, k, w, x)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        inputs = [a.detach().requires_grad_(need)
                  for a, need in zip(saved, ctx.needs_input_grad[2:])]
        with torch.enable_grad():
            out = sddmm_spmm_dense(*inputs, ctx.pat.mask(g.device))
        wanted = [a for a in inputs if a.requires_grad]
        grads = iter(torch.autograd.grad(out, wanted, g))
        return (None, None) + tuple(next(grads) if a.requires_grad else None
                                    for a in inputs)


block_spmm = BlockSpmm("block_spmm")
block_sddmm = BlockSddmm("block_sddmm")
block_sddmm_spmm = BlockSddmmSpmm("block_sddmm_spmm")

_KERNELS = (block_spmm, block_sddmm, block_sddmm_spmm)


def launch_counts() -> Dict[str, int]:
    return {op.name: op.launches for op in _KERNELS}


def reset_launch_counts() -> None:
    for op in _KERNELS:
        op.launches = 0
