"""Callback-driven training logger.

Counterpart of ``dstdgcn_tpu/utils/callbacks.py::CallbackLogger``, in pure
Python and numpy: registered callbacks fire at per-iteration and per-epoch
frequencies: windowed loss averaging to ``<name>_loss.csv``, checkpoint
saving, evaluation, paired-prediction metrics to ``<name>_metrics.yaml``
(when PyYAML is importable) and visual dumps.  An engine calls
:meth:`CallbackLogger.step` each iteration and
:meth:`CallbackLogger.end_epoch` each epoch (``engine.callbacks``).
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict, deque
from typing import Any, Callable, Dict, Optional

import numpy as np

__all__ = ["CallbackLogger"]


class CallbackLogger:
    """Fires registered callbacks on a per-iteration/per-epoch schedule."""

    def __init__(self, log_dir: str, epoch: int = 0, name: str = "log"):
        self.log_dir = log_dir
        self.epoch = epoch
        self.name = name or "log"
        self.iteration = 0
        os.makedirs(log_dir, exist_ok=True)
        self._loss_fcn: Optional[Callable[[], Dict[str, float]]] = None
        self._loss_freq = 0
        self._loss: Dict[str, deque] = {}
        self._loss_rows = []
        self._save_fcn = None
        self._save_freq = 0
        self._eval_fcn = None
        self._eval_freq = 0
        self._metric_fcns = []
        self._pair_fcn = None
        self._metrics = defaultdict(float)
        self._metric_count = 0
        self._visual_fcn = None
        self._visual_freq = 0

    # -- registration (reference add_*_log, log.py:44-75) ------------------

    def add_loss_log(self, loss_fcn: Callable[[], Dict[str, float]],
                     loss_freq: int, window_size: int = 100) -> None:
        self._loss_fcn = loss_fcn
        self._loss_freq = loss_freq
        self._window = window_size

    def add_save_log(self, save_fcn: Callable[[], Any],
                     save_freq: int) -> None:
        self._save_fcn = save_fcn
        self._save_freq = save_freq

    def add_eval_log(self, eval_fcn: Callable[[], Any],
                     eval_freq: int) -> None:
        self._eval_fcn = eval_fcn
        self._eval_freq = eval_freq

    def add_metric_log(self, pair_fcn: Callable[[], tuple],
                       metrics_fcns, metrics_freq: int = 1) -> None:
        self._pair_fcn = pair_fcn
        self._metric_fcns = list(metrics_fcns)
        self._metric_freq = metrics_freq

    def add_visual_log(self, visual_fcn: Callable[[int], Any],
                       visual_freq: int) -> None:
        self._visual_fcn = visual_fcn
        self._visual_freq = visual_freq

    # -- event loop ---------------------------------------------------------

    def step(self) -> str:
        """Advance one iteration; fire due callbacks; return a progress
        string (the reference's tqdm desc, log.py:85-110)."""
        self.iteration += 1
        it = self.iteration
        if self._loss_fcn and self._loss_freq and it % self._loss_freq == 0:
            for k, v in self._loss_fcn().items():
                self._loss.setdefault(
                    k, deque(maxlen=self._window)).append(float(v))
        if self._pair_fcn and self._metric_freq and \
                it % self._metric_freq == 0:
            preds, targets = self._pair_fcn()
            for fname, f in self._metric_fcns:
                self._metrics[fname] += float(f(preds, targets))
            self._metric_count += 1
        if self._visual_fcn and self._visual_freq and \
                it % self._visual_freq == 0:
            self._visual_fcn(it)
        desc = f"[{self.name}][epoch{self.epoch}]"
        desc += " ".join(f"{k} {np.mean(v):.2e}"
                         for k, v in self._loss.items())
        return desc

    def end_epoch(self) -> Dict[str, float]:
        """Close the epoch: flush loss CSV, run save/eval at their epoch
        frequencies, dump averaged metrics; returns the metric averages."""
        self.epoch += 1
        if self._loss:
            row = {"epoch": self.epoch}
            row.update({k: float(np.mean(v)) for k, v in self._loss.items()})
            self._loss_rows.append(row)
            csv_path = os.path.join(self.log_dir, f"{self.name}_loss.csv")
            with open(csv_path, "w", newline="") as f:
                writer = csv.DictWriter(f, fieldnames=list(row.keys()))
                writer.writeheader()
                writer.writerows(self._loss_rows)
        if self._save_fcn and self._save_freq and \
                self.epoch % self._save_freq == 0:
            self._save_fcn()
        if self._eval_fcn and self._eval_freq and \
                self.epoch % self._eval_freq == 0:
            self._eval_fcn()
        averages = {k: v / max(self._metric_count, 1)
                    for k, v in self._metrics.items()}
        if averages:
            try:
                import yaml
                with open(os.path.join(self.log_dir,
                                       f"{self.name}_metrics.yaml"),
                          "w") as f:
                    yaml.safe_dump({self.epoch: averages}, f)
            except ImportError:
                pass
        self._metrics = defaultdict(float)
        self._metric_count = 0
        self.iteration = 0
        return averages
