"""The program's spans in a traced run (``devtrace.Trace``).

The port names its phases with ``torch.profiler.record_function`` while a
profiler records (``dstdgcn_tpu_torch/utils/profiling.py::span``): the
engine's ``engine.forward``, ``engine.backward``, ``engine.optimizer``,
``engine.sync``, ``engine.eval_forward``, ``engine.eval_metric``,
``engine.readback``, and ``dstd.op`` around each DSTD-GC op call.  They
lie in the same trace as the kernels, on its clock.  A program without
them (an older commit) gives no intervals, and every reader None.

* :func:`intervals`: the spans of one name on the thread that drove the
  traced steps (``Trace.window_tid``), merged;
* :func:`device_s`: the device operations whose launch call (found by
  its ``correlation`` id) starts inside those intervals, on any host
  thread: the backward pass launches from autograd's device thread while
  the driving thread waits inside ``engine.backward``;
* :func:`idle_s`: the window's seconds with no device operation running,
  inside those intervals;
* :func:`host_s`: the seconds of the intervals themselves.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple


def intervals(trace, name: str) -> List[Tuple[float, float]]:
    """The merged (start, end) of every span ``name`` on the driving
    thread, in order."""
    if trace is None or trace.window_tid is None:
        return []
    out: List[List[float]] = []
    for ev in trace.host.get(trace.window_tid, []):
        if ev["name"] != name or ev["cat"] != "user_annotation":
            continue
        if out and ev["ts"] <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ev["end"])
        else:
            out.append([ev["ts"], ev["end"]])
    return [(a, b) for a, b in out]


def device_s(trace, name: str) -> Optional[float]:
    """Summed seconds of the device operations launched inside the spans
    ``name``; None without such a span."""
    spans = intervals(trace, name)
    if not spans:
        return None
    starts = [a for a, _ in spans]
    total = 0.0
    for d in trace.device:
        corr = d["args"].get("correlation")
        call = trace.launch.get(int(corr)) if corr is not None else None
        if call is None:
            continue
        i = bisect.bisect_right(starts, call["ts"]) - 1
        if i >= 0 and call["ts"] <= spans[i][1]:
            total += d["end"] - d["ts"]
    return total


def idle_s(trace, name: str) -> Optional[float]:
    """Seconds of the window inside the spans ``name`` in which no device
    operation ran; None without such a span."""
    spans = intervals(trace, name)
    if not spans or trace.window is None:
        return None
    lo, hi = trace.window
    edges = [lo]
    for a, b in trace._merged():
        edges += [a, b]
    edges.append(hi)
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    total, i, j = 0.0, 0, 0
    while i < len(gaps) and j < len(spans):   # both sorted and disjoint
        (a, b), (s, e) = gaps[i], spans[j]
        total += max(0.0, min(b, e) - max(a, s))
        if b < e:
            i += 1
        else:
            j += 1
    return total


def host_s(trace, name: str) -> Optional[float]:
    """Seconds inside the spans ``name``; None without such a span."""
    spans = intervals(trace, name)
    return sum(b - a for a, b in spans) if spans else None


def per_step_ms(run, seconds: Optional[float]) -> Optional[float]:
    """Milliseconds a profiled step or batch; None without a trace."""
    if seconds is None or not run.profiled:
        return None
    return 1e3 * seconds / run.profiled
