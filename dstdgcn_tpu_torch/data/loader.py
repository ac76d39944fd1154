"""Host-side mini-batch iterator over parallel numpy arrays.

Counterpart of ``dstdgcn_tpu/data/loader.py::Loader`` without the device
sharding: it yields numpy batches and the engine moves each batch to its
device.  Deterministic given ``seed`` and the epoch (:meth:`set_epoch`).
Under a multi-process launch each process takes its share of every global
batch, ``idx[process_index::process_count]`` of the batch's indices, as the
JAX loader does.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, ...]

__all__ = ["Loader"]


class Loader:
    """Shuffled mini-batch iterator over parallel arrays."""

    def __init__(self, arrays: Arrays, batch_size: int, shuffle: bool = False,
                 seed: int = 777, drop_last: bool = False,
                 process_index: int = 0, process_count: int = 1):
        n = arrays[0].shape[0]
        if any(a.shape[0] != n for a in arrays):
            raise ValueError("arrays differ in their leading dimension")
        if batch_size % process_count:
            raise ValueError(f"a global batch of {batch_size} does not split "
                             f"over {process_count} processes")
        self.process_index = process_index
        self.process_count = process_count
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = n

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = self.num_samples
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _order(self) -> np.ndarray:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            return rng.permutation(self.num_samples)
        return np.arange(self.num_samples)

    def __iter__(self) -> Iterator[Arrays]:
        order = self._order()
        bs = self.batch_size
        for b in range(len(self)):
            idx = order[b * bs:(b + 1) * bs][
                self.process_index::self.process_count]
            yield tuple(np.ascontiguousarray(a[idx]) for a in self.arrays)
