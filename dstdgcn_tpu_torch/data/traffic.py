"""A seeded traffic series, its forecasting windows and the reading's scaler.

Stands in for a LargeST subset (github.com/liuxu77/LargeST), whose files
are not in the repository: one reading per sensor every 5 minutes (a flow
count: a base level times a daily profile with a morning and an evening
peak, lower at weekends, with noise), and a share ``missing`` of readings
zero, as a detector that reported nothing.  The features of a step are
LargeST's three: the reading, the time of day (a fraction of the day) and
the day of the week (0 to 6).  A window is ``input_n`` steps of the three
features, the reading z-scored, and the raw reading of the ``output_n``
steps after them; the splits are consecutive (LargeST's 6 : 2 : 2).
The scaler is Graph WaveNet's ``StandardScaler``: the mean and standard
deviation of the reading over the training split's input windows.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["STEPS_PER_DAY", "traffic_series", "ZScore", "windows",
           "split_windows"]

#: 5-minute steps in a day
STEPS_PER_DAY = 288


def traffic_series(nodes: int, steps: int, seed: int,
                   missing: float = 0.05) -> np.ndarray:
    """(steps, nodes, 3) float32: the reading, the time of day and the day
    of the week of every step, drawn from ``seed``."""
    rng = np.random.default_rng([int(seed), 13])
    t = np.arange(steps)
    tod = (t % STEPS_PER_DAY) / STEPS_PER_DAY
    dow = (t // STEPS_PER_DAY + rng.integers(0, 7)) % 7
    base = rng.uniform(100.0, 600.0, nodes)
    am, pm = rng.uniform(0.3, 0.8, (2, nodes))
    shift = rng.normal(0.0, 0.02, nodes)
    day = tod[:, None] + shift[None, :]
    profile = (0.25 + 0.35 * np.sin(np.pi * day) ** 2
               + am * np.exp(-((day - 8 / 24) / (1.5 / 24)) ** 2)
               + pm * np.exp(-((day - 17.5 / 24) / (2 / 24)) ** 2))
    weekend = np.where(dow >= 5, 0.75, 1.0)[:, None]
    reading = base * profile * weekend
    reading = reading + rng.normal(0.0, 0.05, reading.shape) * base
    reading = np.maximum(reading, 0.0)
    reading[rng.random(reading.shape) < missing] = 0.0
    out = np.empty((steps, nodes, 3), np.float32)
    out[..., 0] = reading
    out[..., 1] = tod[:, None]
    out[..., 2] = dow[:, None]
    return out


class ZScore:
    """The reading's z-score: ``transform`` (x - mean) / std and
    ``inverse`` x * std + mean, on arrays or tensors of any shape."""

    def __init__(self, mean: float, std: float):
        self.mean = float(mean)
        self.std = float(std)

    def transform(self, x):
        return (x - self.mean) / self.std

    def inverse(self, x):
        return x * self.std + self.mean


def windows(series: np.ndarray, first: int, count: int, input_n: int,
            output_n: int, scaler: ZScore) -> Tuple[np.ndarray, np.ndarray]:
    """(x (count, input_n, V, 3) with the reading z-scored, y (count,
    output_n, V) the raw reading after each) of the windows starting at
    steps ``first`` .. ``first + count - 1``."""
    idx = first + np.arange(count)[:, None]
    x = series[idx + np.arange(input_n)].copy()
    x[..., 0] = scaler.transform(x[..., 0])
    y = series[idx + input_n + np.arange(output_n), :, 0]
    return x.astype(np.float32), np.ascontiguousarray(y, np.float32)


def split_windows(series: np.ndarray, input_n: int, output_n: int,
                  shares: Sequence[float] = (0.6, 0.2, 0.2)) \
        -> Tuple[Dict[str, Tuple[np.ndarray, np.ndarray]], ZScore]:
    """The ``train``, ``val`` and ``test`` windows of ``series`` in
    consecutive shares, and the scaler of the training inputs."""
    total = series.shape[0] - input_n - output_n + 1
    counts = [int(total * s) for s in shares[:2]]
    counts.append(total - sum(counts))
    starts = np.cumsum([0] + counts[:2])
    train_x = series[starts[0] + np.arange(counts[0])[:, None]
                     + np.arange(input_n), :, 0]
    scaler = ZScore(train_x.mean(dtype=np.float64),
                    train_x.std(dtype=np.float64))
    out = {name: windows(series, int(first), count, input_n, output_n,
                         scaler)
           for name, first, count in zip(("train", "val", "test"), starts,
                                         counts)}
    return out, scaler
