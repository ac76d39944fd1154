"""Step timing.

Counterpart of ``StepTimer`` in ``dstdgcn_tpu/utils/profiling.py``; the
profiler trace hook (``trace``) waits for ROADMAP Queue 1 item 11.
"""

from __future__ import annotations

import time
from typing import List, Optional

__all__ = ["StepTimer"]


class StepTimer:
    """Wall-clock timer for training steps.

    Call :meth:`tic` before launching a step and :meth:`toc` once its work
    is complete on the device (the engine synchronizes the card first).
    The first ``skip_first`` steps (lazy set-up, kernel builds) are excluded
    from the statistics.
    """

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self._times: List[float] = []
        self._seen = 0
        self._t0: Optional[float] = None

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.skip_first:
            self._times.append(dt)
        return dt

    @property
    def steps(self) -> int:
        return len(self._times)

    @property
    def avg_ms(self) -> float:
        return 1e3 * sum(self._times) / max(len(self._times), 1)

    @property
    def steps_per_s(self) -> float:
        tot = sum(self._times)
        return len(self._times) / tot if tot > 0 else 0.0

    def summary(self) -> str:
        if not self._times:
            return "no timed steps"
        lo, hi = min(self._times) * 1e3, max(self._times) * 1e3
        return (f"{self.steps} steps | avg {self.avg_ms:.2f} ms | "
                f"min {lo:.2f} / max {hi:.2f} ms | "
                f"{self.steps_per_s:.2f} steps/s")
