"""Running averages for the engine's metrics.

The loss registry of ``dstdgcn_tpu/engine/losses.py`` (jl2, bl2, tl2, cl1,
cl2, gm2) comes with the training slice (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

__all__ = ["AccumLoss"]


class AccumLoss:
    """Running (sum, count) average."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.sum += float(val)
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
