"""The forecast cell's data: a road graph drawn from the configuration's
graph seed, a traffic series on the device drawn from the run's seed, and
the batch source the ``forecast`` loop drives.

The generators are frozen copies of the port's
``dstdgcn_tpu_torch/graphs/road.py::road_graph`` (sensors along freeways,
asymmetric road distances, the thresholded Gaussian kernel of DCRNN and
LargeST, the sensors in a shuffled order) and
``dstdgcn_tpu_torch/data/traffic.py::traffic_series`` (a 5-minute flow per
sensor with a daily profile, lower at weekends, a share of missing zero
readings; the features reading, time of day and day of week).  A batch is
``(x, x_inv, y, y)`` on the device: ``x`` (B, 12, V, 3) the input steps with
the reading z-scored, ``x_inv`` empty (no inverse training), ``y`` (B, 12,
V) the raw reading of the steps after them.  Every seed gives the same
shapes and the same amount of work.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

#: 5-minute steps in a day
STEPS_PER_DAY = 288


def rng_of(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed)] + [int(s) for s in stream])


def road_graph(v: int, seed: int, freeways: int = 40,
               extent_km: float = 80.0, reach_km: float = 7.5,
               kappa: float = 0.1) -> np.ndarray:
    """(v, v) float32 weighted adjacency drawn from ``seed``, in the
    shuffled sensor order."""
    rng = np.random.default_rng([int(seed), 11])
    start = rng.uniform(0, extent_km, (freeways, 2))
    angle = rng.uniform(0, np.pi, freeways)
    length = rng.uniform(0.3, 0.9, freeways) * extent_km
    way = rng.integers(0, freeways, v)
    along = rng.uniform(0, 1, v) * length[way]
    pos = start[way] + along[:, None] * np.stack(
        [np.cos(angle[way]), np.sin(angle[way])], 1)
    pos = pos + rng.normal(0, 0.05, (v, 2))
    pos = pos[rng.permutation(v)]
    euclid = np.sqrt(((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1))
    road = euclid * (1.0 + rng.uniform(0.0, 0.4, (v, v)))
    listed = euclid <= reach_km
    np.fill_diagonal(road, 0.0)
    sigma = road[listed].std()
    w = np.where(listed, np.exp(-np.square(road / sigma)), 0.0)
    w[w < kappa] = 0.0
    return w.astype(np.float32)


def traffic_series(nodes: int, steps: int, seed: int,
                   missing: float = 0.05) -> np.ndarray:
    """(steps, nodes, 3) float32: reading, time of day, day of week."""
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
    """The reading's scaler: ``inverse`` x * std + mean (the engine
    de-normalises the prediction with it)."""

    def __init__(self, mean: float, std: float):
        self.mean, self.std = float(mean), float(std)

    def transform(self, x):
        return (x - self.mean) / self.std

    def inverse(self, x):
        return x * self.std + self.mean


class Series:
    """The seeded series of ``days`` days on ``device`` and its windows of
    ``input_n`` + ``output_n`` steps; the scaler is the mean and standard
    deviation of the reading over the series."""

    def __init__(self, nodes: int, days: float, seed: int, missing: float,
                 input_n: int, output_n: int, device):
        steps = int(days * STEPS_PER_DAY)
        host = traffic_series(nodes, steps, seed, missing)
        reading = host[..., 0].astype(np.float64)
        self.scaler = ZScore(reading.mean(), reading.std())
        self.data = torch.from_numpy(host).to(device)
        self.input_n, self.output_n = input_n, output_n
        self.count = steps - input_n - output_n + 1
        self.device = device

    def __len__(self) -> int:
        return self.count

    def batch(self, idx: np.ndarray):
        """(x, x_inv, y, y) of the windows starting at ``idx``."""
        idx = torch.as_tensor(np.asarray(idx), device=self.device)
        steps = idx[:, None] + torch.arange(self.input_n, device=self.device)
        x = self.data[steps]
        x = torch.cat([self.scaler.transform(x[..., :1]), x[..., 1:]], -1)
        later = idx[:, None] + self.input_n + torch.arange(
            self.output_n, device=self.device)
        y = self.data[later, :, 0]
        return x, x.new_empty((len(idx), 0)), y, y


class Stream:
    """Epochs of ``len(self)`` batches over the windows, each epoch in an
    order drawn from the seed, as one stream that goes on where the last
    ``iter`` stopped; fetching after ``deadline`` ends the iteration."""

    def __init__(self, series: Series, batch_size: int, seed: int):
        self.series = series
        self.batch_size = batch_size
        self.seed = seed
        self.deadline: Optional[float] = None
        self.epoch = 0
        self.pos = 0
        self.order = self._order(0)
        #: the windows of every batch fetched so far, in order
        self.fetched: List[np.ndarray] = []

    def _order(self, epoch: int) -> np.ndarray:
        return rng_of(self.seed, 3, epoch).permutation(len(self.series))

    def __len__(self) -> int:
        return len(self.series) // self.batch_size

    def __iter__(self):
        return self

    def __next__(self):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise StopIteration
        if self.pos + self.batch_size > len(self.order):
            self.epoch += 1
            self.pos = 0
            self.order = self._order(self.epoch)
        idx = self.order[self.pos:self.pos + self.batch_size]
        self.pos += self.batch_size
        self.fetched.append(idx)
        return self.series.batch(idx)
