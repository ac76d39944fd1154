"""The traced part of a run: a ``torch.profiler`` trace of a fixed number of
steps, read back from its Chrome trace.

:func:`profile` runs a callable under the profiler (host operators and the
card's activity through CUPTI) inside an annotation named ``WINDOW``,
which also spans the final synchronize, so every device operation of the
profiled steps lies inside it.  The trace is written to a temporary file,
read and deleted.  :class:`Trace` gives what the per-layer readers need:

* device operations (kernels, copies, fills) with their times;
* the device operations launched under a host operation of a given name,
  found through the ``External id`` that the profiler gives a kernel and
  the host operation that launched it (or, where a kernel has none,
  through its launch call's ``correlation`` id and the host operation that
  encloses that call on its thread): everything the operation's subtree
  launched, whatever the kernels are called;
* host seconds inside operations, the device's busy seconds (the union
  of device operation intervals) and the idle gaps, each labelled by the
  innermost host operation running at the gap's middle on the thread that
  drove the steps, or, where that thread was in none, on another thread
  (autograd's device thread runs the backward pass).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Tuple

#: the annotation around the profiled steps
WINDOW = "bench.window"
#: categories of device operations and of host-side events in the trace
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KERNEL_CATS = ("kernel",)
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


class Trace:
    """A parsed Chrome trace of one profiled window (times in seconds)."""

    def __init__(self, events: Iterable[dict]):
        self.device: List[dict] = []
        self.host: Dict[int, List[dict]] = defaultdict(list)
        self.launch: Dict[int, dict] = {}
        self.window: Optional[Tuple[float, float]] = None
        self.window_tid = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts = float(e["ts"]) * 1e-6
            ev = dict(name=e.get("name", ""), cat=cat, ts=ts,
                      end=ts + float(e.get("dur", 0)) * 1e-6,
                      tid=e.get("tid"), args=e.get("args") or {})
            if cat in DEVICE_CATS:
                self.device.append(ev)
            elif cat == "user_annotation" and ev["name"] == WINDOW:
                self.window = (ev["ts"], ev["end"])
                self.window_tid = ev["tid"]
            elif cat in HOST_CATS or cat == "user_annotation":
                self.host[ev["tid"]].append(ev)
                if cat in ("cuda_runtime", "cuda_driver"):
                    corr = ev["args"].get("correlation")
                    if corr is not None:
                        self.launch[int(corr)] = ev
        for evs in self.host.values():
            evs.sort(key=lambda ev: (ev["ts"], -ev["end"]))
        self.device.sort(key=lambda ev: ev["ts"])
        if self.window is not None:
            lo, hi = self.window
            self.device = [d for d in self.device
                           if d["end"] > lo and d["ts"] < hi]
        self._start_cache: Dict[object, List[float]] = {}
        self._parent_cache: Dict[object, List[int]] = {}
        self._by_ext = {}
        for tid, evs in self.host.items():
            for ev in evs:
                ext = ev["args"].get("External id")
                if ev["cat"] == "cpu_op" and ext is not None:
                    self._by_ext[int(ext)] = ev

    # -- sizes ----------------------------------------------------------

    @property
    def window_s(self) -> float:
        return 0.0 if self.window is None else self.window[1] - self.window[0]

    def kernels(self) -> List[dict]:
        return [d for d in self.device if d["cat"] in KERNEL_CATS]

    def busy_s(self) -> float:
        """Seconds of the window in which a device operation ran."""
        return sum(hi - lo for lo, hi in self._merged())

    def _merged(self) -> List[Tuple[float, float]]:
        lo_w, hi_w = self.window or (float("-inf"), float("inf"))
        out: List[List[float]] = []
        for d in self.device:
            lo, hi = max(d["ts"], lo_w), min(d["end"], hi_w)
            if hi <= lo:
                continue
            if out and lo <= out[-1][1]:
                out[-1][1] = max(out[-1][1], hi)
            else:
                out.append([lo, hi])
        return [(a, b) for a, b in out]

    # -- attribution -------------------------------------------------------

    def _innermost(self, tid, t: float) -> Optional[dict]:
        """The innermost host operation on thread ``tid`` that spans ``t``:
        from the latest-starting event before ``t`` up its enclosing events
        to the first that has not ended by then."""
        i = bisect.bisect_right(self._starts(tid), t) - 1
        evs, up = self.host.get(tid, []), self._parents(tid)
        while i >= 0:
            ev = evs[i]
            if ev["end"] >= t and ev["cat"] not in ("cuda_runtime",
                                                    "cuda_driver"):
                return ev
            i = up[i]
        return None

    def _starts(self, tid) -> List[float]:
        if tid not in self._start_cache:
            self._start_cache[tid] = [ev["ts"] for ev in self.host.get(tid,
                                                                      [])]
        return self._start_cache[tid]

    def _parents(self, tid) -> List[int]:
        """Index of each event's enclosing event on its thread (-1 for
        none), from one pass with a stack over the events in start order."""
        if tid not in self._parent_cache:
            up, stack = [], []
            for i, ev in enumerate(self.host.get(tid, [])):
                while stack and self.host[tid][stack[-1]]["end"] < ev["end"]:
                    stack.pop()
                up.append(stack[-1] if stack else -1)
                stack.append(i)
            self._parent_cache[tid] = up
        return self._parent_cache[tid]

    def _doing(self, t: float) -> Optional[dict]:
        """What the host was doing at ``t``: the innermost operation of the
        driving thread, or where that thread is in none (it waits, say, on
        the autograd engine's device thread), the innermost operation of
        any other thread."""
        ev = self._innermost(self.window_tid, t)
        if ev is not None and ev["cat"] != "user_annotation":
            return ev
        others = [e for tid in self.host if tid != self.window_tid
                  for e in [self._innermost(tid, t)] if e is not None]
        if others:
            return max(others, key=lambda e: e["ts"])
        return ev

    def _owner(self, d: dict) -> Optional[dict]:
        """The host operation that launched device operation ``d``."""
        ext = d["args"].get("External id")
        if ext is not None and int(ext) in self._by_ext:
            return self._by_ext[int(ext)]
        corr = d["args"].get("correlation")
        call = self.launch.get(int(corr)) if corr is not None else None
        if call is None:
            return None
        return self._innermost(call["tid"], call["ts"])

    def device_s_under(self, name: str) -> Tuple[float, int]:
        """(device seconds, count) of the device operations launched inside
        every host operation called ``name`` (its whole subtree)."""
        inside = set()
        for tid, evs in self.host.items():
            starts = self._starts(tid)
            for ev in evs:
                if ev["name"] != name:
                    continue
                i = bisect.bisect_left(starts, ev["ts"])
                while i < len(evs) and evs[i]["ts"] <= ev["end"]:
                    if evs[i]["end"] <= ev["end"]:
                        inside.add(id(evs[i]))
                    i += 1
        total, count = 0.0, 0
        for d in self.device:
            own = self._owner(d)
            if own is not None and id(own) in inside:
                total += d["end"] - d["ts"]
                count += 1
        return total, count

    def host_s(self) -> float:
        """Seconds the host threads spent inside operations and launch
        calls (the outermost events of each thread, the window's own
        annotation left out)."""
        total = 0.0
        for evs in self.host.values():
            end = float("-inf")
            for ev in evs:
                if ev["cat"] == "user_annotation":
                    continue
                if ev["ts"] >= end:
                    total += ev["end"] - ev["ts"]
                    end = ev["end"]
                elif ev["end"] > end:
                    total += ev["end"] - end
                    end = ev["end"]
        return total

    # -- breakdown ----------------------------------------------------------

    def top_device_ops(self, count: int = 10) -> List[list]:
        by = defaultdict(float)
        for d in self.device:
            by[d["name"][:160]] += d["end"] - d["ts"]
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:count]]

    def idle_gaps(self, count: int = 10) -> List[list]:
        """Idle seconds of the window summed by the innermost host operation
        running at each gap's middle on the driving thread."""
        if self.window is None:
            return []
        lo, hi = self.window
        edges = [lo]
        for a, b in self._merged():
            edges += [a, b]
        edges.append(hi)
        by = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            ev = self._doing((a + b) / 2)
            by[(ev["name"] if ev else "outside any operation")[:160]] += b - a
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                [:count]]


def profile(torch, fn: Callable[[], None], tries: int = 3,
            seconds: Optional[dict] = None) -> Trace:
    """Run ``fn`` under ``torch.profiler`` and parse its trace; a trace
    that holds no device operation (CUPTI now and then records nothing)
    is taken again, up to ``tries`` times in all.  ``seconds`` receives
    the host seconds of profiling, of writing and of reading the trace."""
    from torch.profiler import ProfilerActivity
    trace = Trace([])
    seconds = {} if seconds is None else seconds
    for _ in range(tries):
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as p:
            with torch.profiler.record_function(WINDOW):
                fn()
                torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            t1 = time.perf_counter()
            p.export_chrome_trace(path)
            t2 = time.perf_counter()
            with open(path) as f:
                trace = Trace(json.load(f).get("traceEvents", []))
            seconds.update(profile=t1 - t0, write=t2 - t1,
                           read=time.perf_counter() - t2,
                           megabytes=os.path.getsize(path) / 2 ** 20)
        finally:
            os.unlink(path)
        if trace.kernels():
            break
    return trace
