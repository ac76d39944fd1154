"""Layout and DCT transforms, as tensor ops.

Counterpart of ``dstdgcn_tpu/data/transforms.py``.  The engine's exchange
layout is flat ``(B, T, V*C)``; the model consumes channels-last
``(B, T, V, C)``.  ``tsc`` is the transform of every shipped config; the
``tscr_*`` variants also reorder joints into a limb-grouped order.  The
scale normalizers (:class:`MeanStdNorm`, :class:`MinMaxNorm`) take numpy
arrays at dataset build and tensors in the engine, on any device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["get_transform", "TimeTransform", "MeanStdNorm", "MinMaxNorm",
           "mirror_sequences", "padding_indices", "dct_matrix"]

# limb-grouped joint orders
_TSCR_ORDERS = {
    "h36m": [21, 20, 19, 18, 17, 12, 13, 14, 15, 16, 11, 10, 9, 8, 4, 5, 6,
             7, 0, 1, 2, 3],
    "cmu": [23, 21, 20, 14, 15, 17, 12, 11, 9, 5, 6, 7, 1, 2, 3, 0, 4, 8,
            10, 13, 19, 16, 18, 22, 24],
    "3dpw": [22, 20, 18, 16, 13, 12, 15, 17, 19, 21, 14, 11, 8, 5, 2, 1, 4,
             7, 10, 0, 3, 6, 9],
}


def _inverse_order(order):
    inv = np.empty(len(order), np.int64)
    inv[np.asarray(order)] = np.arange(len(order))
    return inv.tolist()


def st_transform(x: torch.Tensor) -> torch.Tensor:
    """(B, T, S) -> (B, S, T)."""
    return x.transpose(1, 2)


def st_inverse(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2)


def tsc_transform(x: torch.Tensor, c: int = 3) -> torch.Tensor:
    """(B, T, S*C) -> (B, T, S, C)."""
    b, t, sc = x.shape
    return x.reshape(b, t, sc // c, c)


def tsc_inverse(x: torch.Tensor, c: int = 3) -> torch.Tensor:
    b, t, s, cc = x.shape
    return x.reshape(b, t, s * cc)


def cst_transform(x: torch.Tensor, c: int = 3) -> torch.Tensor:
    """(B, T, S*C) -> (B, C, S, T)."""
    b, t, sc = x.shape
    return x.reshape(b, t, sc // c, c).permute(0, 3, 2, 1)


def cst_inverse(x: torch.Tensor, c: int = 3) -> torch.Tensor:
    b, cc, s, t = x.shape
    return x.permute(0, 3, 2, 1).reshape(b, t, s * cc)


def _make_tscr(layout: str):
    fwd = _TSCR_ORDERS[layout]
    inv = _inverse_order(fwd)

    def transform(x: torch.Tensor, c: int = 3) -> torch.Tensor:
        return tsc_transform(x, c)[:, :, fwd, :]

    def inverse(x: torch.Tensor, c: int = 3) -> torch.Tensor:
        return tsc_inverse(x[:, :, inv, :], c)

    return transform, inverse


TRANSFORMS: Dict[str, Tuple[Optional[Callable], Optional[Callable]]] = {
    "st": (st_transform, st_inverse),
    "tsc": (tsc_transform, tsc_inverse),
    "cst": (cst_transform, cst_inverse),
    "no": (None, None),
}
for _lay in _TSCR_ORDERS:
    TRANSFORMS[f"tscr_{_lay}"] = _make_tscr(_lay)


def get_transform(name: str):
    """-> (transform, inverse) pair; both None for ``no``."""
    try:
        return TRANSFORMS[name]
    except KeyError:
        raise ValueError(f"unknown transform {name!r}") from None


def dct_matrix(n: int) -> Tuple[np.ndarray, np.ndarray]:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    w = np.where(k == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
    m = w * np.cos(np.pi * (i + 0.5) * k / n)
    return m.astype(np.float64), np.linalg.inv(m).astype(np.float64)


class TimeTransform:
    """Truncated-DCT temporal compression over numpy arrays or tensors."""

    def __init__(self, seq_len: int, dct_used: int):
        self.seq_len = seq_len
        self.dct_used = dct_used
        dct, idct = dct_matrix(seq_len)
        self.dct = dct[:dct_used].astype(np.float32)       # (D, T)
        self.idct = idct[:, :dct_used].astype(np.float32)  # (T, D)

    @staticmethod
    def _apply(m: np.ndarray, eq: str, x):
        if isinstance(x, torch.Tensor):
            return torch.einsum(eq, torch.as_tensor(m, device=x.device), x)
        return np.einsum(eq, m, x)

    def transform(self, x):
        """(N, T, S) -> (N, D, S)."""
        return self._apply(self.dct, "dt,nts->nds", x)

    def inverse(self, x):
        """(N, D, S) -> (N, T, S)."""
        return self._apply(self.idct, "td,nds->nts", x)


class _Stats:
    """numpy statistics of a scaler and their tensor copies, made once per
    (device, dtype) and reused by every batch."""

    def __init__(self):
        self._tensors: Dict[Tuple[torch.device, torch.dtype],
                            Tuple[torch.Tensor, ...]] = {}

    def _cast(self, x, *stats: np.ndarray):
        if not isinstance(x, torch.Tensor):
            return stats
        key = (x.device, x.dtype)
        got = self._tensors.get(key)
        if got is None:
            got = self._tensors[key] = tuple(
                torch.as_tensor(m, dtype=x.dtype, device=x.device)
                for m in stats)
        return got


class MeanStdNorm(_Stats):
    """Per-dimension standardization, ``(x - mean) / std``."""

    def __init__(self, mean, std):
        super().__init__()
        self.mean = np.asarray(mean, np.float32)[None, None, :]
        self.std = np.asarray(std, np.float32)[None, None, :]

    def transform(self, x):
        mean, std = self._cast(x, self.mean, self.std)
        return (x - mean) / std

    def inverse(self, x):
        mean, std = self._cast(x, self.mean, self.std)
        return x * std + mean


class MinMaxNorm(_Stats):
    """[-1, 1] min-max scaling."""

    def __init__(self, v_min, v_max):
        super().__init__()
        self.v_min = np.asarray(v_min, np.float32)
        self.gap = np.asarray(v_max - v_min, np.float32)

    def transform(self, x):
        v_min, gap = self._cast(x, self.v_min, self.gap)
        return (x - v_min) / gap * 2 - 1

    def inverse(self, x):
        v_min, gap = self._cast(x, self.v_min, self.gap)
        return (x + 1) / 2 * gap + v_min


def mirror_sequences(seqs: np.ndarray, right, left) -> np.ndarray:
    """Left/right mirror augmentation over flat (N, T, V*3) sequences:
    swaps the given joint index lists and negates x."""
    n, t, vc = seqs.shape
    s = seqs.reshape(n, t, vc // 3, 3)
    m = s.copy()
    m[:, :, list(right)] = s[:, :, list(left)]
    m[:, :, list(left)] = s[:, :, list(right)]
    m[..., 0] = -m[..., 0]
    return m.reshape(n, t, vc)


def padding_indices(input_n: int, output_n: int,
                    padding: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """(forward, inverse-time) input frame index maps.

    Forward: input frames then ``output_n`` copies of the last input frame;
    inverse: the time-reversed view used by inverse-sequence training.
    """
    if padding:
        i_idx = np.concatenate([np.arange(input_n),
                                np.full(output_n, input_n - 1)])
        i_idx_inv = np.concatenate([
            np.arange(output_n, output_n + input_n)[::-1],
            np.full(output_n, output_n)])
    else:
        i_idx = np.arange(input_n + output_n)
        i_idx_inv = i_idx[::-1]
    return i_idx.astype(np.int64), i_idx_inv.astype(np.int64)
