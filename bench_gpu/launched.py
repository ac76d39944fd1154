"""Device time launched inside a program span, on the launching thread.

``devtrace.Trace.device_s_under`` gives a device operation to the host
operation its ``External id`` names, which for a kernel launched inside a
span nested in a custom autograd Function (``sparse.spmm`` inside
``_SpmmFunction`` forward, or inside its backward node; the spans that
``utils/profiling.py::spanned`` reopens in a backward) is the Function's
node around the span, not the span.  ``spans.device_s`` takes the spans of
the driving thread alone, and autograd's device thread launches the
backward pass inside spans of its own.  Here a device operation counts
for the span ``name`` when its launch call (found by its ``correlation``
id) starts inside a span of that name on the thread that made the call,
whichever thread that is.  The forecast cell's span readers
(``diffusion_device_ms.forecast``, ``spmm_device_ms.forecast``,
``roofline.spmm.forecast``) all read through :func:`device_s`.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple


def _spans(trace, name: str) -> Dict[object, List[Tuple[float, float]]]:
    """The merged (start, end) of the spans ``name`` on each thread."""
    out = {}
    for tid, evs in trace.host.items():
        merged: List[List[float]] = []
        for ev in evs:            # in start order
            if ev["name"] != name or ev["cat"] != "user_annotation":
                continue
            if merged and ev["ts"] <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], ev["end"])
            else:
                merged.append([ev["ts"], ev["end"]])
        if merged:
            out[tid] = [(a, b) for a, b in merged]
    return out


def device_s(trace, name: str) -> Tuple[float, int]:
    """(device seconds, count) of the device operations whose launch call
    starts inside a span ``name`` on its own thread."""
    if trace is None:
        return 0.0, 0
    spans = _spans(trace, name)
    starts = {tid: [a for a, _ in iv] for tid, iv in spans.items()}
    total, count = 0.0, 0
    for d in trace.device:
        corr = d["args"].get("correlation")
        call = trace.launch.get(int(corr)) if corr is not None else None
        if call is None or call["tid"] not in spans:
            continue
        iv = spans[call["tid"]]
        i = bisect.bisect_right(starts[call["tid"]], call["ts"]) - 1
        if i >= 0 and call["ts"] <= iv[i][1]:
            total += d["end"] - d["ts"]
            count += 1
    return total, count
