"""Seeded motion windows and the batch sources the benchmark drives.

The generator is a frozen copy of ``dstdgcn_tpu_torch/data/datasets.py``'s
``Synthetic`` (band-limited random motion: a sum of three low-frequency
sinusoids per coordinate around a random base pose) and of
``MotionDataset``'s windowing (the ``dim_used`` columns, the observed
frames padded with the last one, the time-reversed variant for inverse
training).  A batch is what the port's loader yields:
``(inputs, inputs_inv, targets, all_seqs)``, numpy float32.

Every seed gives the same shapes and the same amount of work; the seed
changes only the values and the order of the rows.
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def rng_of(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator of ``seed`` (any non-negative integer) and a
    stream id: independent draws for the train pool, the test pool, the
    order of each epoch and the sampled answers."""
    return np.random.default_rng([int(seed)] + [int(s) for s in stream])


def dim_used(graph: dict) -> np.ndarray:
    """Columns of the used joints in the full skeleton's (V_full * 3)."""
    used = np.asarray(graph["used_joints"])
    return np.sort(np.concatenate([used * 3, used * 3 + 1, used * 3 + 2]))


def padding_indices(input_n: int, output_n: int):
    """(forward, inverse-time) input frame index maps: the observed frames
    then ``output_n`` copies of the last one; the time-reversed view."""
    i_idx = np.concatenate([np.arange(input_n),
                            np.full(output_n, input_n - 1)])
    i_idx_inv = np.concatenate([np.arange(output_n, output_n + input_n)[::-1],
                                np.full(output_n, output_n)])
    return i_idx.astype(np.int64), i_idx_inv.astype(np.int64)


def motion(rng: np.random.Generator, count: int, frames: int,
           full_joints: int) -> np.ndarray:
    """(count, frames, full_joints * 3) float32 band-limited motion."""
    d = full_joints * 3
    base = rng.standard_normal((count, 1, d)) * 100
    freqs = rng.uniform(0.02, 0.2, (count, 3, 1, d))
    phase = rng.uniform(0, 2 * np.pi, freqs.shape)
    amp = rng.standard_normal(freqs.shape) * 40
    ts = np.arange(frames)[None, None, :, None]
    seqs = base[:, None] + amp * np.sin(2 * np.pi * freqs * ts + phase)
    return seqs.sum(axis=1).astype(np.float32)


class Windows:
    """Windowed quadruples of ``count`` seeded sequences in a
    configuration's layout (``config["graph"]``, ``config["setting"]``)."""

    def __init__(self, config: dict, seed: int, stream: int, count: int):
        setting, graph = config["setting"], config["graph"]
        input_n, output_n = int(setting["input_n"]), int(setting["output_n"])
        self.all_seqs = motion(rng_of(seed, stream), count,
                               input_n + output_n, int(graph["full_joints"]))
        used = self.all_seqs[:, :, dim_used(graph)]
        i_idx, i_idx_inv = padding_indices(input_n, output_n)
        self.arrays = (np.ascontiguousarray(used[:, i_idx]),
                       np.ascontiguousarray(used[:, i_idx_inv]),
                       np.ascontiguousarray(used), self.all_seqs)

    def __len__(self) -> int:
        return self.arrays[0].shape[0]

    def batch(self, idx: np.ndarray) -> Batch:
        """The rows ``idx``, copied as the port's loader copies them."""
        return tuple(np.ascontiguousarray(a[idx]) for a in self.arrays)


class TrainStream:
    """The training batch source: epochs of ``len(self)`` batches over a
    pool of windows, each epoch in an order drawn from the seed, as one
    stream that goes on where the last ``iter`` stopped.  With a
    ``deadline`` (``time.perf_counter`` seconds) set, fetching a batch
    after it ends the iteration, so the engine's epoch ends there."""

    def __init__(self, windows: Windows, batch_size: int, seed: int):
        self.windows = windows
        self.batch_size = batch_size
        self.seed = seed
        self.deadline: Optional[float] = None
        self.epoch = 0
        self.pos = 0
        self.order = self._order(0)
        #: the rows of every batch fetched so far, in order
        self.fetched: List[np.ndarray] = []

    def _order(self, epoch: int) -> np.ndarray:
        return rng_of(self.seed, 3, epoch).permutation(len(self.windows))

    def __len__(self) -> int:
        return len(self.windows) // self.batch_size

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise StopIteration
        if self.pos + self.batch_size > len(self.order):
            self.epoch += 1
            self.pos = 0
            self.order = self._order(self.epoch)
        idx = self.order[self.pos:self.pos + self.batch_size]
        self.pos += self.batch_size
        self.fetched.append(idx)
        return self.windows.batch(idx)


class ActionLoader:
    """The batches of one action's test windows, in order (``shuffle``
    off, as the runners' test loaders), with the index of the batch being
    served in ``current`` and the shared deadline of :class:`TrainStream`."""

    def __init__(self, windows: Windows, rows: np.ndarray, batch_size: int,
                 first: int, clock: "Deadline"):
        self.windows = windows
        self.rows = rows
        self.batch_size = batch_size
        self.first = first        # global index of this action's batch 0
        self.clock = clock
        self.current = -1

    def __len__(self) -> int:
        return -(-len(self.rows) // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        for b in range(len(self)):
            if self.clock.passed():
                return
            self.current = self.first + b
            yield self.windows.batch(
                self.rows[b * self.batch_size:(b + 1) * self.batch_size])


class Deadline:
    """A deadline on ``time.perf_counter``, None while unset."""

    def __init__(self):
        self.at: Optional[float] = None

    def passed(self) -> bool:
        return self.at is not None and time.perf_counter() >= self.at


def action_loaders(windows: Windows, actions: int, batch_size: int,
                   clock: Deadline) -> List[ActionLoader]:
    """``actions`` loaders over equal consecutive shares of the test
    windows, their batches numbered globally."""
    per = len(windows) // actions
    loaders, first = [], 0
    for a in range(actions):
        rows = np.arange(a * per, (a + 1) * per)
        loaders.append(ActionLoader(windows, rows, batch_size, first, clock))
        first += len(loaders[-1])
    return loaders
