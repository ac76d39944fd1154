"""Faults planted under the forecast loop's timed path, to show that
``correct`` catches them (``calibrate_forecast.py`` reads them on the card,
the harness's tests on the CPU).  Each takes the engine before its first
step."""

from __future__ import annotations

import numpy as np

from .faults import frozen, half_batch


def dropped_block(engine) -> None:
    """The forward road support's SpMM without one of its active blocks:
    of the blocks whose block row keeps another, the one that holds the
    most edges."""
    model = engine.model
    rows, cols = model.support_blocks[0]
    block = int(model.block)
    adj = model.support_0[0].detach().cpu().numpy()
    grid = adj.reshape(adj.shape[0] // block, block, -1, block)
    edges = np.count_nonzero(grid, axis=(1, 3))[rows, cols]
    edges[np.bincount(rows)[rows] < 2] = -1
    keep = np.arange(len(rows)) != int(np.argmax(edges))
    model.support_blocks[0] = (rows[keep], cols[keep])


#: the faults of the forecast loop's cells
BY_NAME = {"frozen": frozen, "half_batch": half_batch,
           "dropped_block": dropped_block}
