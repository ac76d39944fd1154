"""Program spans and the profiler trace hook.

``span`` names a region of the port (the engine's phases, a DSTD-GC op
call) in whatever ``torch.profiler`` records it: a span is a
``record_function`` while a profiler records, on the trace's own clock
beside the host operators and the card's kernels, and one shared null
context otherwise, so that a span costs one check when nothing records.
``spanned`` names a computation in both directions: its forward inside
the span, and its backward pass, which autograd runs later and maybe on
another thread, inside a span of the same name opened when the gradient
reaches the computation's output and closed when it has left its inputs.
``trace`` (the counterpart of ``trace`` in
``dstdgcn_tpu/utils/profiling.py``) records ``torch.profiler`` activity
(host operators and, with a card, its kernels) and writes it as one Chrome
trace into a directory (the ``engine.profile`` config key).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, ContextManager, Iterator, Optional

import torch

__all__ = ["span", "spanned", "trace"]

_NO_SPAN = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str) -> ContextManager:
    """A ``torch.profiler.record_function`` named ``name`` while a profiler
    records, else a null context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class _Bracket(torch.autograd.Function):
    """Identity forward; its backward opens the span of ``box`` (at a
    computation's output) or closes it once every bracketed input has been
    reached (at its inputs)."""

    @staticmethod
    def forward(ctx, x, box, opens):
        ctx.box, ctx.opens = box, opens
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        box = ctx.box
        if ctx.opens:
            box["span"] = torch.profiler.record_function(box["name"])
            box["span"].__enter__()
        else:
            box["open"] -= 1
            if box["open"] == 0 and "span" in box:
                box.pop("span").__exit__(None, None, None)
        return g, None, None


def spanned(name: str, fn: Callable[..., torch.Tensor],
            *inputs: torch.Tensor) -> torch.Tensor:
    """``fn(*inputs)`` inside the span ``name``, whose backward pass runs
    inside a span of the same name too, while a profiler records; else
    just ``fn(*inputs)``.  Every input that needs a gradient must reach
    the output."""
    if not _recording():
        return fn(*inputs)
    box = dict(name=name, open=0)
    with torch.profiler.record_function(name):
        if torch.is_grad_enabled():
            inputs = tuple(_Bracket.apply(x, box, False) if x.requires_grad
                           else x for x in inputs)
            box["open"] = sum(x.requires_grad for x in inputs)
        out = fn(*inputs)
        if box["open"] and out.requires_grad:
            out = _Bracket.apply(out, box, True)
    return out


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Record ``torch.profiler`` activity (of the CPU, and of the card
    when a card is present) and write it to ``log_dir`` as
    ``trace_<pid>_<time ns>.json`` in the Chrome trace format (no-op if
    ``log_dir`` is None or empty)."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
