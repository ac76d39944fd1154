"""Motion datasets (numpy): Human3.6M, CMU Mocap, 3DPW and a synthetic
generator.

Counterpart of ``dstdgcn_tpu/data/datasets.py``.  Loading stays in numpy
with the same operations and random streams, so the port's arrays equal
the JAX package's byte for byte:

  * sample-rate frame downsampling, zeroed global rotation/translation,
    forward kinematics to 3D joints (:mod:`.kinematics`; CMU runs it
    before downsampling, H36M after);
  * sliding-window extraction; SRNN-seeded test-window selection with the
    literature seed 1234567890;
  * mirror augmentation, output padding with the last input frame and the
    reversed-index variant for inverse-sequence training;
  * optional DCT / mean-std scaling and motion-magnitude joint weights.

Expmap CSV files are read by the native reader (:mod:`.native`); a file it
cannot read as a matrix (ragged) goes to ``np.loadtxt``.
:func:`reader_counts` says which reader served how many files.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import numpy as np

from ..graphs import skeleton as sk
from . import kinematics as K
from . import transforms as tfm
from .native import fast_read_csv

__all__ = ["H36M_ACTIONS", "CMU_ACTIONS", "EXPI_SPLITS", "define_actions",
           "read_csv_floats", "reader_counts", "reset_reader_counts",
           "sliding_windows", "find_indices_srnn", "load_h36m_3d",
           "load_h36m_angles", "load_cmu_angles", "load_cmu_3d",
           "MotionDataset", "Human36M", "CMUMocap", "PW3D", "Synthetic",
           "get_dataset"]


H36M_ACTIONS = [
    "walking", "eating", "smoking", "discussion", "directions", "greeting",
    "phoning", "posing", "purchases", "sitting", "sittingdown",
    "takingphoto", "waiting", "walkingdog", "walkingtogether",
]
CMU_ACTIONS = [
    "basketball", "basketball_signal", "directing_traffic", "jumping",
    "running", "soccer", "walking", "washwindow",
]
# ExPI acro-couple splits (reference utils.py:331-414); actions are
# "<actor>/<sequence>" paths
_EXPI_PRO3_TRAIN = [f"{a}/{s}" for a in ("2", "1") for s in (
    "a-frame", "around-the-back", "coochie", "frog-classic", "noser",
    "toss-out", "cartwheel")]
EXPI_SPLITS = {
    "pro3-train": _EXPI_PRO3_TRAIN,
    "pro3-test": ["2/crunch-toast", "2/frog-kick", "2/ninja-kick",
                  "1/back-flip", "1/big-ben", "1/chandelle",
                  "1/check-the-change", "1/frog-turn", "1/twisted-toss"],
    "pro1-train": _EXPI_PRO3_TRAIN[:7],
    "pro1-test": _EXPI_PRO3_TRAIN[7:],
}


def define_actions(action: str, dataset: str = "h36m"):
    """Action-list resolver, parity with utils.py:314-426 (incl. the expi
    split names and the amass no-op)."""
    if dataset == "expi":
        return list(EXPI_SPLITS.get(action, []))
    if dataset == "amass":
        return []
    actions = {"h36m": H36M_ACTIONS, "cmu": CMU_ACTIONS}[dataset]
    if action in actions:
        return [action]
    if action == "all":
        return list(actions)
    if action == "debug":
        return actions[:1]
    raise ValueError(f"Unrecognized action: {action}")


#: files served by each reader since the last :func:`reset_reader_counts`
_READS = {"native": 0, "loadtxt": 0}


def read_csv_floats(filename: str) -> np.ndarray:
    """Comma-separated float matrix: the native reader, or ``np.loadtxt``
    for a file the native reader returns None for (ragged)."""
    out = fast_read_csv(filename)
    if out is not None:
        _READS["native"] += 1
        return out
    _READS["loadtxt"] += 1
    return np.loadtxt(filename, delimiter=",", dtype=np.float32, ndmin=2)


def reader_counts() -> Dict[str, int]:
    """Files read by the native reader and by ``np.loadtxt``."""
    return dict(_READS)


def reset_reader_counts() -> None:
    for key in _READS:
        _READS[key] = 0


def sliding_windows(seq: np.ndarray, seq_len: int) -> np.ndarray:
    """(F, D) -> (F - seq_len + 1, seq_len, D) overlapping windows (view)."""
    n = seq.shape[0] - seq_len + 1
    if n <= 0:
        return np.zeros((0, seq_len) + seq.shape[1:], seq.dtype)
    return np.lib.stride_tricks.sliding_window_view(
        seq, seq_len, axis=0).transpose(0, 2, 1)


def find_indices_srnn(frame_num1, frame_num2, seq_len, input_n=10, count=4):
    """SRNN-compatible random test windows (utils.py:998-1027; the 256-
    window variant is the same with count=128, utils.py:966-995)."""
    rng = np.random.RandomState(1234567890)
    t1, t2 = frame_num1 - 150, frame_num2 - 150
    idx1, idx2 = [], []
    for _ in range(count):
        r1 = rng.randint(16, t1)
        r2 = rng.randint(16, t2)
        idx1.append(np.arange(r1 + 50 - input_n, r1 + 50 - input_n + seq_len))
        idx2.append(np.arange(r2 + 50 - input_n, r2 + 50 - input_n + seq_len))
    return np.stack(idx1), np.stack(idx2)


def _h36m_dims():
    # constant joints + duplicated joints (utils.py:945-947)
    joint_to_ignore = np.array([0, 1, 6, 11, 16, 20, 23, 24, 28, 31])
    dim_ignore = np.concatenate([joint_to_ignore * 3, joint_to_ignore * 3 + 1,
                                 joint_to_ignore * 3 + 2])
    dim_used = np.setdiff1d(np.arange(96), dim_ignore)
    return dim_ignore, dim_used


def load_h36m_3d(data_path: str, subjects, actions, sample_rate: int,
                 seq_len: int, test_mode: str = "8"):
    """Reference ``load_data_3d`` (utils.py:825-950): read expmap CSVs,
    zero global channels, FK to 3D, downsample, window."""
    skel = K.h36m_skeleton()
    sampled = []
    for subj in subjects:
        for action in actions:
            if subj != 5:
                for subact in (1, 2):
                    fn = f"{data_path}/S{subj}/{action}_{subact}.txt"
                    seq = read_csv_floats(fn)[::sample_rate].copy()
                    seq[:, 0:6] = 0
                    p3d = K.forward_kinematics(seq, skel).reshape(
                        len(seq), -1)
                    sampled.append(sliding_windows(p3d, seq_len))
            else:
                seqs = []
                for subact in (1, 2):
                    fn = f"{data_path}/S{subj}/{action}_{subact}.txt"
                    seq = read_csv_floats(fn)[::sample_rate].copy()
                    seq[:, 0:6] = 0
                    seqs.append(K.forward_kinematics(seq, skel).reshape(
                        len(seq), -1))
                n1, n2 = len(seqs[0]), len(seqs[1])
                if test_mode == "8":
                    f1, f2 = find_indices_srnn(n1, n2, seq_len)
                elif test_mode == "256":
                    f1, f2 = find_indices_srnn(n1, n2, seq_len, count=128)
                elif test_mode == "all":
                    f1 = np.array([np.arange(i, i + seq_len)
                                   for i in range(n1 - 100)])
                    f2 = np.array([np.arange(i, i + seq_len)
                                   for i in range(n2 - 100)])
                else:
                    raise ValueError(f"Invalid test_mode {test_mode}")
                sampled.append(seqs[0][f1])
                sampled.append(seqs[1][f2])
    all_seqs = np.concatenate(sampled, axis=0)
    dim_ignore, dim_used = _h36m_dims()
    return all_seqs, dim_ignore, dim_used


def _std_dims(complete_seq: np.ndarray):
    """Std-threshold channel split of the angle loaders (utils.py:815-822):
    channels with std < 1e-4 over the concatenated raw sequences are
    ignored; their stats are pinned to mean 0 / std 1."""
    data_std = complete_seq.std(axis=0)
    data_mean = complete_seq.mean(axis=0)
    dim_ignore = np.where(data_std < 1e-4)[0]
    dim_used = np.where(data_std >= 1e-4)[0]
    data_std = data_std.copy()
    data_mean = data_mean.copy()
    data_std[dim_ignore] = 1.0
    data_mean[dim_ignore] = 0.0
    return dim_ignore, dim_used, data_mean, data_std


def load_h36m_angles(data_path: str, subjects, actions, sample_rate: int,
                     seq_len: int, input_n: int = 10, test_mode: str = "8"):
    """Reference ``load_data`` (utils.py:728-822): windows over the RAW
    expmap channels — no forward kinematics, global translation/rotation
    kept — selected by ``data_3d: False`` (dataset/h36m.py:37-44).

    Reference-parity notes (latent bugs fixed on our side, deliberately):
      * the reference call site unpacks 3 of the 5 returned values and
        passes ``test_mode`` (a string) into the numeric ``input_n``
        parameter (dataset/h36m.py:44-45), so the angle path crashes as
        shipped; this implements the intended semantics with the same
        window protocols as the 3D loader (sliding windows for train
        subjects, SRNN-seeded windows for subject 5).
      * in the reference, subject-5 windows after the first action are
        dropped by the ``len(sampled_seq) == 0`` guard (utils.py:806-812);
        harmless in the runner flow (one action per test dataset),
        implemented correctly here.

    Returns ``(all_seqs, dim_ignore, dim_used, data_mean, data_std)`` with
    ``dim_used`` = channels whose std is >= 1e-4 (see :func:`_std_dims`).
    """
    sampled, complete = [], []
    for subj in subjects:
        for action in actions:
            if subj != 5:
                for subact in (1, 2):
                    fn = f"{data_path}/S{subj}/{action}_{subact}.txt"
                    seq = read_csv_floats(fn)[::sample_rate]
                    sampled.append(sliding_windows(seq, seq_len))
                    complete.append(seq)
            else:
                seqs = []
                for subact in (1, 2):
                    fn = f"{data_path}/S{subj}/{action}_{subact}.txt"
                    seqs.append(read_csv_floats(fn)[::sample_rate])
                n1, n2 = len(seqs[0]), len(seqs[1])
                if test_mode == "8":
                    f1, f2 = find_indices_srnn(n1, n2, seq_len,
                                               input_n=input_n)
                elif test_mode == "256":
                    f1, f2 = find_indices_srnn(n1, n2, seq_len,
                                               input_n=input_n, count=128)
                elif test_mode == "all":
                    f1 = np.array([np.arange(i, i + seq_len)
                                   for i in range(n1 - 100)])
                    f2 = np.array([np.arange(i, i + seq_len)
                                   for i in range(n2 - 100)])
                else:
                    raise ValueError(f"Invalid test_mode {test_mode}")
                sampled.append(seqs[0][f1])
                sampled.append(seqs[1][f2])
                complete.extend(seqs)
    all_seqs = np.concatenate(sampled, axis=0)
    dim_ignore, dim_used, mean, std = _std_dims(np.concatenate(complete, 0))
    return all_seqs, dim_ignore, dim_used, mean, std


def load_cmu_angles(data_path: str, actions, input_n: int, output_n: int,
                    data_std=None, data_mean=None, is_test: bool = False):
    """Reference ``load_data_cmu`` (utils.py:463-523): windows over raw CMU
    expmap channels, frames downsampled by the hard-coded factor 2.

    The reference's CMU angle branch is unimplemented (``pass`` at
    dataset/cmu.py:45-47, leaving ``all_seqs`` unbound); this provides the
    loader it stubs out.  Test windows follow the per-file SRNN protocol
    (seed 1234567890, 8 windows from a 50+25-frame span, utils.py:494-510).
    As in the reference, test loads reuse the train-time ``data_std`` /
    ``data_mean`` for the std-threshold channel split (utils.py:513-523).
    """
    seq_len = input_n + output_n
    sampled, complete = [], []
    for action in actions:
        path = os.path.join(data_path, action)
        count = len(os.listdir(path))
        for idx in range(count):
            fn = os.path.join(path, f"{action}_{idx + 1}.txt")
            seq = read_csv_floats(fn)[::2]
            complete.append(seq)
            if not is_test:
                sampled.append(sliding_windows(seq, seq_len))
            else:
                src, tgt = 50, 25
                rng = np.random.RandomState(1234567890)
                for _ in range(8):
                    i = rng.randint(0, len(seq) - (src + tgt))
                    sampled.append(seq[None, i + src - input_n:
                                       i + src + output_n])
    all_seqs = np.concatenate(sampled, axis=0)
    if is_test and data_std is not None:
        std = np.asarray(data_std, dtype=np.float64).copy()
        mean = np.asarray(data_mean, dtype=np.float64).copy()
        dim_ignore = np.where(std < 1e-4)[0]
        dim_used = np.where(std >= 1e-4)[0]
        std[dim_ignore] = 1.0
        mean[dim_ignore] = 0.0
    else:
        dim_ignore, dim_used, mean, std = _std_dims(
            np.concatenate(complete, 0))
    return all_seqs, dim_ignore, dim_used, mean, std


def load_cmu_3d(data_path: str, actions, sample_rate: int, input_n: int,
                output_n: int, mode: str = "all"):
    """Reference ``load_data_cmu_3d`` (utils.py:526-592)."""
    skel = K.cmu_skeleton()
    seq_len = input_n + output_n
    sampled = []
    for action in actions:
        path = os.path.join(data_path, action)
        count = len(os.listdir(path))
        for idx in range(count):
            fn = os.path.join(path, f"{action}_{idx + 1}.txt")
            raw = read_csv_floats(fn)
            xyz = K.forward_kinematics(raw, skel).reshape(len(raw), -1)
            seq = xyz[::sample_rate]
            if mode == "all":
                sampled.append(sliding_windows(seq, seq_len))
            elif mode == "8":
                src, tgt = 50, 25
                rng = np.random.RandomState(1234567890)
                for _ in range(8):
                    i = rng.randint(0, len(seq) - (src + tgt))
                    sampled.append(seq[None, i + src - input_n:
                                       i + src + output_n])
            else:
                raise ValueError(f"Invalid mode {mode}")
    all_seqs = np.concatenate(sampled, axis=0)
    joint_to_ignore = np.array([0, 1, 2, 7, 8, 13, 16, 20, 29, 24, 27, 33,
                                36])
    dim_ignore = np.concatenate([joint_to_ignore * 3, joint_to_ignore * 3 + 1,
                                 joint_to_ignore * 3 + 2])
    dim_used = np.setdiff1d(np.arange(all_seqs.shape[2]), dim_ignore)
    return all_seqs, dim_ignore, dim_used


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

        if scale:
            if scaler is not None:
                self.scale_tsfm = scaler
            else:
                n, t, vc = used.shape
                flat = used.reshape(n * t, vc)
                self.scale_tsfm = tfm.MeanStdNorm(flat.mean(0), flat.std(0))
            self.input_seqs = self.scale_tsfm.transform(self.input_seqs)
            self.input_seqs_inv = self.scale_tsfm.transform(
                self.input_seqs_inv)
            self.output_seqs = self.scale_tsfm.transform(self.output_seqs)
        else:
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


class Human36M(MotionDataset):
    """dataset/h36m.py parity."""

    SUBJECTS = dict(train=[1, 6, 7, 8, 9], test=[5], valid=[11], debug=[1])

    def __init__(self, data_path, actions="all", input_n=20, output_n=10,
                 dct_used=15, mode="train", sample_rate=2, scale=False,
                 scaler=None, data_3d=True, test_mode="all", mirror=False,
                 padding=True):
        acts = define_actions(actions, "h36m")
        if data_3d:
            all_seqs, _, dim_used = load_h36m_3d(
                data_path, self.SUBJECTS[mode], acts, sample_rate,
                input_n + output_n, test_mode)
            layout = "h36m"
        else:
            # angle-space (expmap) loading, dataset/h36m.py:43-45; mirror
            # augmentation only supports 3D data (reference comment :39-41)
            all_seqs, _, dim_used, self.angle_mean, self.angle_std = \
                load_h36m_angles(data_path, self.SUBJECTS[mode], acts,
                                 sample_rate, input_n + output_n,
                                 input_n=input_n, test_mode=test_mode)
            layout, mirror = None, False
        super().__init__(all_seqs, dim_used, input_n, output_n,
                         layout=layout, mirror=mirror, padding=padding,
                         dct_used=dct_used, apply_dct=True, scale=scale,
                         scaler=scaler)


class CMUMocap(MotionDataset):
    """dataset/cmu.py parity."""

    def __init__(self, data_path, actions="all", input_n=20, output_n=10,
                 dct_used=15, mode="train", sample_rate=2, scale=False,
                 scaler=None, data_3d=True, test_mode="all", mirror=False,
                 padding=True):
        del mode
        acts = define_actions(actions, "cmu")
        if data_3d:
            all_seqs, _, dim_used = load_cmu_3d(data_path, acts, sample_rate,
                                                input_n, output_n, test_mode)
            layout = "cmu"
        else:
            # angle-space loader the reference stubs out (dataset/cmu.py:45)
            all_seqs, _, dim_used, self.angle_mean, self.angle_std = \
                load_cmu_angles(data_path, acts, input_n, output_n,
                                is_test=(test_mode == "8"))
            layout, mirror = None, False
        super().__init__(all_seqs, dim_used, input_n, output_n, layout=layout,
                         mirror=mirror, padding=padding, dct_used=dct_used,
                         apply_dct=False, scale=scale, scaler=scaler)


class PW3D(MotionDataset):
    """dataset/pw3d.py parity: pickled SMPL joint positions, root-centred,
    metres -> millimetres, root joint dropped from ``dim_used``."""

    def __init__(self, data_path, input_n=20, output_n=10, dct_used=15,
                 mode="train", scale=False, scaler=None, mirror=False,
                 padding=True):
        del mode
        seq_len = input_n + output_n
        files = []
        for dirpath, _, filenames in os.walk(data_path):
            files.extend(os.path.join(dirpath, f) for f in filenames)
        windows = []
        for f in sorted(files):
            with open(f, "rb") as fh:
                data = pickle.load(fh, encoding="latin1")
            for seqs in data["jointPositions"]:
                seqs = seqs - np.tile(seqs[:, 0:3], (1, 24))
                windows.append(sliding_windows(seqs, seq_len))
        all_seqs = np.concatenate(windows, axis=0) * 1000.0
        dim_used = np.arange(3, all_seqs.shape[2])
        super().__init__(all_seqs, dim_used, input_n, output_n,
                         layout="3dpw", mirror=mirror, padding=padding,
                         dct_used=dct_used, apply_dct=False, scale=scale,
                         scaler=scaler)


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


_DATASETS = {
    "h36m": Human36M,
    "cmu": CMUMocap,
    "3dpw": PW3D,
    "synthetic": Synthetic,
}


def get_dataset(name: str, **opts) -> MotionDataset:
    """Dataset factory: the per-dataset options live under ``opts[name]``."""
    if name not in _DATASETS:
        raise ValueError(f"unknown dataset {name!r}")
    kwargs = dict(opts.get(name, opts))
    kwargs.pop("name", None)
    return _DATASETS[name](**kwargs)
