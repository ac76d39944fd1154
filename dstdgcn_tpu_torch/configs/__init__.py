"""Configs of the port as Python dicts (no PyYAML needed).

``SYNTHETIC_H36M_SERVING`` and ``SYNTHETIC_H36M_TRAIN`` equal
``synthetic_h36m_serving.yaml`` and ``synthetic_h36m_train.yaml`` as
``yaml.safe_load`` reads them (``!!python`` values unresolved); pass either
form to :func:`dstdgcn_tpu_torch.main.run`.  :func:`synthetic_h36m_serving`
and :func:`synthetic_h36m_train` return fresh deep copies, since runners
update the config in place.
"""

from __future__ import annotations

import copy

__all__ = ["SYNTHETIC_H36M_SERVING", "synthetic_h36m_serving",
           "SYNTHETIC_H36M_TRAIN", "synthetic_h36m_train"]

_SYNTHETIC = dict(layout="h36m", num_sequences=256, input_n=10, output_n=25,
                  dct_used=0, mirror=False)

SYNTHETIC_H36M_SERVING = {
    "runner": "synthetic",
    "save": {
        "path": {"base": "runs/", "files": "scripts/",
                 "checkpoints": "checkpoints/",
                 "tensorboard": "tensorboard/", "visualize": "visualize/"},
        "files": [],
    },
    "train_batch_size": 32,
    "test_batch_size": 32,
    "num_workers": 0,
    "epoch": 1,
    "mode": "test",
    "dataset": {
        "name": "synthetic",
        "scale": False,
        "train": {"synthetic": dict(_SYNTHETIC, mode="train")},
        "test": {"synthetic": dict(_SYNTHETIC, mode="test")},
    },
    "setting": {
        "input_n": 10,
        "output_n": 25,
        "eval_frame": [1, 3, 7, 9, 13, 17, 21, 24],
        "dim_used": "!!python sorted([j*3+k for j in [2,3,4,5,7,8,9,10,12,"
                    "13,14,15,17,18,19,21,22,25,26,27,29,30] for k in "
                    "range(3)])",
        "joint_to_ignore": [16, 20, 23, 24, 28, 31],
        "joint_to_equal": [13, 19, 22, 13, 27, 30],
        "save": False,
    },
    "model": {
        "name": "dstdgcn",
        "load": False,
        "ckpt": "None",
        "use_pallas": "serving",
        "dstdgcn": {
            "input_channels": 6,
            "input_time_frame": 10,
            "output_time_frame": 25,
            "st_gcnn_dropout": 0.1,
            "joints_to_consider": 22,
            "num_feature": 64,
            "num_layers": 5,
            "layout": "h36m",
            "compute_dtype": None,
        },
    },
    "engine": {
        "learn": {"opt": "adam", "lr": 3.e-3, "weight_decay": 0,
                  "gamma": 0.9, "step_size": 5},
        "loss": {"joint": ["jl2", 1]},
        "n_out": 1,
        "transform": "tsc",
        "use_weight": False,
        "inverse": True,
        "max_iter": -1,
        "fused_inference": False,
    },
}


def synthetic_h36m_serving() -> dict:
    return copy.deepcopy(SYNTHETIC_H36M_SERVING)


#: the serving config's model at full width, trained: 256 train and 64 test
#: sequences, 2 epochs, both DSTD-GC ops through the CUDA kernels
SYNTHETIC_H36M_TRAIN = copy.deepcopy(SYNTHETIC_H36M_SERVING)
SYNTHETIC_H36M_TRAIN.update(epoch=2, mode="train")
SYNTHETIC_H36M_TRAIN["dataset"]["test"]["synthetic"]["num_sequences"] = 64
SYNTHETIC_H36M_TRAIN["model"]["use_pallas"] = True
del SYNTHETIC_H36M_TRAIN["engine"]["fused_inference"]


def synthetic_h36m_train() -> dict:
    return copy.deepcopy(SYNTHETIC_H36M_TRAIN)
