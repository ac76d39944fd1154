"""Temporal (frame) graph builders (numpy).

The port's own copy of ``dstdgcn_tpu/graphs/temporal.py``: dense (T, T)
adjacencies over the frame axis.  Kinds: ``self``, ``neighbor`` (alias
``neighboor``), ``tridiag``, ``inout`` and ``all``.

NOTE on ``neighbor``: it is built with whole-block assignments
``adj[:-1, 1:] = eye(T-1); adj[1:, :-1] = eye(T-1)``.  Each assignment
overwrites its block, so the result is NOT tri-diagonal: the sub-diagonal is
all ones, the main diagonal survives only at (0,0) and (T-1,T-1), and the
super-diagonal only at (0,1) and (T-2,T-1).  Trained models depend on this
exact matrix, so it is reproduced bit for bit; ``tridiag`` is the symmetric
tri-diagonal.
"""

from __future__ import annotations

import numpy as np

__all__ = ["adjacency", "stacked_adjacency"]

#: length of the observed (input) block for the ``inout`` / ``all`` kinds
DEFAULT_INPUT_LENGTH = 10


def adjacency(seq_length: int, kind: str = "neighbor",
              input_length: int = DEFAULT_INPUT_LENGTH) -> np.ndarray:
    t = seq_length
    if kind == "self":
        return np.eye(t, dtype=np.float32)
    if kind in ("neighbor", "neighboor"):
        adj = np.eye(t, dtype=np.float32)
        # block overwrites (see module docstring)
        adj[:-1, 1:] = np.eye(t - 1, dtype=np.float32)
        adj[1:, :-1] = np.eye(t - 1, dtype=np.float32)
        return adj
    if kind == "tridiag":
        adj = np.eye(t, dtype=np.float32)
        idx = np.arange(t - 1)
        adj[idx, idx + 1] = 1.0
        adj[idx + 1, idx] = 1.0
        return adj
    if kind == "inout":
        adj = np.zeros((t, t), np.float32)
        adj[:input_length, input_length:] = 1.0
        adj[input_length:, :input_length] = 1.0
        return adj
    if kind == "all":
        adj = adjacency(t, "neighbor")
        adj[:input_length, input_length:] = 1.0
        adj[input_length:, :input_length] = 1.0
        return adj
    raise ValueError(f"invalid temporal adjacency kind {kind!r}")


def stacked_adjacency(seq_length: int) -> np.ndarray:
    """(1, T, T) stack of [neighbor]."""
    return adjacency(seq_length, "neighbor")[None]
