"""Graph WaveNet's dense adaptive hop, ``out = adp^T x``, and its gradients
on the hand-written 3xTF32 ``wgmma`` kernels of ``csrc/dense_hop.cu``.

``dense_hop(adp, x)``: adp (V, V), x (V, F) -> (V, F), the product
``torch.mm(adp.t(), x)`` of ``models/gwnet.py::GWNet._gcn`` (``nconv`` over
the adaptive support on the node-major activation).  Differentiable: the
backward computes ``d_x = adp g`` and ``d_adp = x g^T``.

On a CUDA tensor each product launches the kernel or raises; on a CPU
tensor it runs its plain version, the ``torch.mm`` call autograd through
``torch.mm(adp.t(), x)`` makes (``mm``'s backward with adp^T
column-major: ``x.mm(g.t())`` and ``adp.mm(g)``), so the CPU path equals
it bit for bit.  The kernels read the adjacency with its depth along its
rows and each row padded to a multiple of 4 floats (the tensor memory
accelerator takes row strides of 16 bytes): the forward reads adp^T, d_x
adp.  Those copies live in an :class:`Operands`, which the caller builds
once per adjacency and passes to every hop over it (``GWNet.forward``:
one a step, ``dense_hop(adp, x, ops)``); a call without one builds its
own.  ``.launches`` counts the product launches (a training step of the
forecast configuration: 16 forward, 14 ``d_x``, 14 ``d_adp``).  Every
launch, and the copies, run inside the program span ``dense.hop``
(:func:`..utils.profiling.span`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import build

__all__ = ["Operands", "dense_hop", "hop_dense", "launch_counts",
           "reset_launch_counts"]

LIBRARY = "dense_hop"
SPAN = "dense.hop"


def hop_dense(adp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``adp^T x``."""
    return torch.mm(adp.t(), x)


def _check(name: str, adp, x):
    for key, t in (("adp", adp), ("x", x)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {key} is {t.dtype}; the kernel takes "
                            "float32")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if adp.dim() != 2 or adp.shape[0] != adp.shape[1] or x.dim() != 2 \
            or x.shape[0] != adp.shape[0]:
        raise ValueError(f"{name}: adp (V, V) and x (V, F) expected, got "
                         f"{tuple(adp.shape)} and {tuple(x.shape)}")
    if adp.device != x.device:
        raise ValueError(f"{name}: adp on {adp.device}, x on {x.device}")
    if adp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {adp.device}")
    if adp.device.type == "cuda":
        if x.shape[1] % 4:
            raise ValueError(f"{name}: F = {x.shape[1]}; the kernel reads "
                             "rows of 16 bytes, F must be a multiple of 4")
        for key, t in (("adp", adp), ("x", x)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {key} must start on a 16-byte "
                                 "boundary")


class Operands:
    """The adjacency as the hop kernels read it: ``data`` (``adp`` itself,
    which the CPU path reads) and per orientation (``True``: adp^T, the
    forward's; ``False``: adp, ``d_x``'s) a copy with its rows padded to a
    multiple of 4 floats, made at the first product that reads it.  Built
    after the adjacency's last change: a copy is not remade."""

    def __init__(self, adp: torch.Tensor):
        self.data = adp.detach()
        self._padded: Dict[bool, torch.Tensor] = {}

    def get(self, transposed: bool) -> torch.Tensor:
        if transposed not in self._padded:
            with profiling.span(SPAN):
                a = self.data.t() if transposed else self.data
                pad = -a.shape[1] % 4
                self._padded[transposed] = F.pad(a, (0, pad)).contiguous()
        return self._padded[transposed]


class DenseHop:
    """``dense_hop(adp, x, ops=None)``: adp (V, V), x (V, F) float32,
    contiguous -> ``adp^T x`` (V, F); F a multiple of 4 on the card.
    ``ops``: the :class:`Operands` of adp, shared by the calls over it."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def __call__(self, adp: torch.Tensor, x: torch.Tensor,
                 ops: Optional[Operands] = None) -> torch.Tensor:
        _check(self.name, adp, x)
        if ops is None:
            ops = Operands(adp)
        elif (ops.data.data_ptr() != adp.data_ptr()
              or ops.data.shape != adp.shape):
            raise ValueError(f"{self.name}: ops hold another adjacency")
        if torch.is_grad_enabled() and (adp.requires_grad
                                        or x.requires_grad):
            return _HopFunction.apply(self, ops, adp, x)
        return self.forward(ops, x)

    # -- the three products, outside autograd --------------------------------

    def forward(self, ops: Operands, x: torch.Tensor) -> torch.Tensor:
        """``adp^T x``."""
        with profiling.span(SPAN):
            if x.device.type == "cpu":
                return hop_dense(ops.data, x)
            return self._hop(ops.get(True), x)

    def d_x(self, ops: Operands, g: torch.Tensor) -> torch.Tensor:
        """``adp g``."""
        with profiling.span(SPAN):
            if g.device.type == "cpu":
                return torch.mm(ops.data, g)
            return self._hop(ops.get(False), g)

    def d_adp(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """``x g^T``."""
        with profiling.span(SPAN):
            if g.device.type == "cpu":
                return torch.mm(x, g.t())
            v, f = x.shape
            out = torch.empty((v, v), device=x.device, dtype=torch.float32)
            self._launch("dense_outer_f32", x.data_ptr(), g.data_ptr(),
                         out.data_ptr(), v, f, *_where(x))
            return out

    # -- launches ------------------------------------------------------------

    def _hop(self, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        v, f = x.shape
        out = torch.empty_like(x)
        self._launch("dense_hop_f32", x.data_ptr(), b.data_ptr(),
                     out.data_ptr(), v, f, b.shape[1], *_where(x))
        return out

    def _launch(self, fname: str, *args):
        lib = build.library(LIBRARY)
        err = getattr(lib, fname)(*args)
        if err != 0:
            msg = lib.dstd_error_string(err).decode()
            raise RuntimeError(f"{fname} kernel launch failed: cudaError "
                               f"{err} ({msg})")
        self.launches += 1


def _where(t: torch.Tensor):
    """(device index, stream handle) of a launch on t's device."""
    return t.device.index, torch.cuda.current_stream(t.device).cuda_stream


class _HopFunction(torch.autograd.Function):
    """The kernel forward; the backward ``d_adp = x g^T`` and ``d_x = adp
    g``, each a kernel launch (or its plain product on the CPU).  adp is
    saved for autograd's check that it was not changed in place before
    the backward, which reads its copies."""

    @staticmethod
    def forward(ctx, op, ops, adp, x):
        ctx.op, ctx.ops = op, ops
        ctx.save_for_backward(adp, x)
        return op.forward(ops, x)

    @staticmethod
    def backward(ctx, g):
        _, x = ctx.saved_tensors
        g = g.contiguous()
        if g.device.type == "cuda" and g.data_ptr() % 16:
            g = g.clone()
        d_adp = d_x = None
        if ctx.needs_input_grad[2]:
            d_adp = ctx.op.d_adp(x, g)
        if ctx.needs_input_grad[3]:
            d_x = ctx.op.d_x(ctx.ops, g)
        return None, None, d_adp, d_x


dense_hop = DenseHop("dense_hop")


def launch_counts() -> Dict[str, int]:
    return {dense_hop.name: dense_hop.launches}


def reset_launch_counts() -> None:
    dense_hop.launches = 0
