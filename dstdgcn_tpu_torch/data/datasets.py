"""Motion datasets (numpy): the windowed dataset and the synthetic generator.

Counterpart of ``MotionDataset``, ``Synthetic`` and ``get_dataset`` in
``dstdgcn_tpu/data/datasets.py``.  Generation stays in numpy with the same
random streams, so the port's data matches the JAX package's byte for byte.
The real-dataset loaders (Human3.6M, CMU Mocap, 3DPW) are a later slice.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..graphs import skeleton as sk
from . import transforms as tfm

__all__ = ["MotionDataset", "Synthetic", "get_dataset"]


class MotionDataset:
    """Windowed (input, inverse-input, target, full) sequence quadruples.

    ``input_seqs`` / ``input_seqs_inv`` / ``output_seqs`` are views over the
    ``dim_used`` columns; ``all_seqs`` keeps the full skeleton for
    evaluation.
    """

    def __init__(self, all_seqs: np.ndarray, dim_used: np.ndarray,
                 input_n: int, output_n: int, layout: Optional[str] = None,
                 mirror: bool = False, padding: bool = True,
                 dct_used: int = 0, apply_dct: bool = False,
                 scale: bool = False, scaler=None):
        if scale or scaler is not None:
            raise NotImplementedError(
                "scale normalization is not ported yet (ROADMAP Queue 1 "
                "item 5)")
        if mirror and layout is not None:
            lay = sk.get_layout(layout)
            m = tfm.mirror_sequences(all_seqs, lay.mirror_right,
                                     lay.mirror_left)
            all_seqs = np.concatenate([all_seqs, m], axis=0)
        self.all_seqs = all_seqs.astype(np.float32)
        self.dim_used = np.asarray(dim_used)

        i_idx, i_idx_inv = tfm.padding_indices(input_n, output_n, padding)
        used = self.all_seqs[:, :, self.dim_used]
        self.input_seqs = used[:, i_idx, :].copy()
        self.input_seqs_inv = used[:, i_idx_inv, :].copy()
        self.output_seqs = used.copy()

        if dct_used > 0:
            self.time_tsfm = tfm.TimeTransform(input_n + output_n, dct_used)
            if apply_dct:
                self.input_seqs = self.time_tsfm.transform(self.input_seqs)
                self.output_seqs = self.time_tsfm.transform(self.output_seqs)
        else:
            self.time_tsfm = None
        self.scale_tsfm = None

        # motion-magnitude joint weights
        n, t, vc = self.all_seqs.shape
        motion = np.abs(np.diff(self.all_seqs.reshape(n, t, vc // 3, 3),
                                axis=1))
        w = motion.mean(axis=(0, 1, 3))
        denom = max(w.max() - w.min(), 1e-12)
        self.joint_weight_all = (w - w.min()) / denom
        self.joint_weight_use = self.joint_weight_all[
            np.unique(self.dim_used // 3)]

    def __len__(self):
        return self.input_seqs.shape[0]

    def arrays(self):
        return (self.input_seqs, self.input_seqs_inv, self.output_seqs,
                self.all_seqs)

    def __getitem__(self, i):
        return (self.input_seqs[i], self.input_seqs_inv[i],
                self.output_seqs[i], self.all_seqs[i])


class Synthetic(MotionDataset):
    """Band-limited random motion over any layout (no files needed)."""

    def __init__(self, layout="h36m", num_sequences=64, input_n=10,
                 output_n=10, dct_used=0, mode="train", scale=False,
                 scaler=None, mirror=False, padding=True, seed=0,
                 full_joints: Optional[int] = None, **_):
        lay = sk.get_layout(layout)
        v_full = full_joints or lay.full_joints
        t = input_n + output_n
        rng = np.random.RandomState(seed + (0 if mode == "train" else 1))
        # smooth trajectories: sum of low-frequency sinusoids per coord
        base = rng.randn(num_sequences, 1, v_full * 3) * 100
        freqs = rng.uniform(0.02, 0.2, (num_sequences, 3, 1, v_full * 3))
        phase = rng.uniform(0, 2 * np.pi, freqs.shape)
        amp = rng.randn(*freqs.shape) * 40
        ts = np.arange(t)[None, None, :, None]
        seqs = base[:, None] + (amp * np.sin(
            2 * np.pi * freqs * ts + phase))
        all_seqs = seqs.sum(axis=1).astype(np.float32)
        dims = np.sort(np.concatenate(
            [np.asarray(lay.used_joints) * 3,
             np.asarray(lay.used_joints) * 3 + 1,
             np.asarray(lay.used_joints) * 3 + 2]))
        super().__init__(all_seqs, dims, input_n, output_n, layout=layout,
                         mirror=mirror, padding=padding, dct_used=dct_used,
                         scale=scale, scaler=scaler)


_DATASETS = {"synthetic": Synthetic}
_LATER = ("h36m", "cmu", "3dpw")


def get_dataset(name: str, **opts) -> MotionDataset:
    """Dataset factory: the per-dataset options live under ``opts[name]``."""
    if name in _LATER:
        raise NotImplementedError(
            f"dataset {name!r} needs the real-dataset loaders, which are not "
            "ported yet (ROADMAP Queue 1 item 10)")
    if name not in _DATASETS:
        raise ValueError(f"unknown dataset {name!r}")
    kwargs = dict(opts.get(name, opts))
    kwargs.pop("name", None)
    return _DATASETS[name](**kwargs)
