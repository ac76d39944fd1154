"""Program spans and the profiler trace hook.

``span`` names a region of the port (the engine's phases, a DSTD-GC op
call) in whatever ``torch.profiler`` records it: a span is a
``record_function`` while a profiler records, on the trace's own clock
beside the host operators and the card's kernels, and one shared null
context otherwise, so that a span costs one check when nothing records.
``trace`` (the counterpart of ``trace`` in
``dstdgcn_tpu/utils/profiling.py``) records ``torch.profiler`` activity
(host operators and, with a card, its kernels) and writes it as one Chrome
trace into a directory (the ``engine.profile`` config key).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import ContextManager, Iterator, Optional

import torch

__all__ = ["span", "trace"]

_NO_SPAN = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled


def span(name: str) -> ContextManager:
    """A ``torch.profiler.record_function`` named ``name`` while a profiler
    records, else a null context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NO_SPAN


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
