"""Device-time measurement helpers.

Counterpart of ``dstdgcn_tpu/utils/timing.py``: to time an op without
letting the work be skipped, apply it ``iters`` times with its OUTPUT
carried from one application to the next (:func:`loop_fn`), so every
application must run.  :func:`time_looped` times that loop on the tensor's
device: CUDA events on a card, ``time.perf_counter`` on the CPU.
"""

from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["loop_fn", "time_looped"]


def loop_fn(op: Callable, iters: int) -> Callable:
    """Return ``x -> op(op(...op(x)))`` (``iters`` times).

    ``op`` must be shape-preserving; its output is the carry, so each
    application consumes the one before it.
    """
    def f(x):
        for _ in range(iters):
            x = op(x)
        return x
    return f


def time_looped(op: Callable, x0: torch.Tensor, iters: int = 30,
                repeats: int = 3) -> float:
    """Best seconds per application of ``op`` over ``repeats`` runs of
    :func:`loop_fn` on ``x0``, after one warm run: CUDA events when ``x0``
    lies on a card, ``time.perf_counter`` when it lies on the CPU."""
    f = loop_fn(op, iters)
    f(x0)                           # warm: kernel builds, allocator
    best = float("inf")
    for _ in range(repeats):
        if x0.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(x0.device)
            start.record()
            f(x0)
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            f(x0)
            seconds = time.perf_counter() - t0
        best = min(best, seconds / iters)
    return best
