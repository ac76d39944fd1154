"""Configs of the port as Python dicts (no PyYAML needed).

``SYNTHETIC_H36M_SERVING``, ``SYNTHETIC_H36M_FUSED``,
``SYNTHETIC_H36M_TRAIN``, ``SYNTHETIC_H36M_DP_TRAIN``,
``SYNTHETIC_H36M_GRAPH_TRAIN``, ``SYNTHETIC_H36M_MODEL_TRAIN``,
``SYNTHETIC_H36M_FAST_GRAPH_TRAIN``, ``SYNTHETIC_H36M_ENGINE_TRAIN``,
``SYNTHETIC_H36M_TPU_TRAIN``, ``SYNTHETIC_H36M_TPU_FUSED``,
``REAL_H36M_TRAIN``, ``REAL_CMU_TRAIN`` and ``REAL_3DPW_TRAIN`` equal the YAML files of the same names in lower case
as ``yaml.safe_load`` reads them (``!!python`` values unresolved); pass
either form to :func:`dstdgcn_tpu_torch.main.run`.  The real-data configs
read their files from each split's ``data_path``, which the caller sets
(:func:`set_data_paths`).  The functions of the same names in lower case
return fresh deep copies, since runners update the config in place.
"""

from __future__ import annotations

import copy

__all__ = ["SYNTHETIC_H36M_SERVING", "synthetic_h36m_serving",
           "SYNTHETIC_H36M_FUSED", "synthetic_h36m_fused",
           "SYNTHETIC_H36M_TRAIN", "synthetic_h36m_train",
           "SYNTHETIC_H36M_DP_TRAIN", "synthetic_h36m_dp_train",
           "SYNTHETIC_H36M_GRAPH_TRAIN", "synthetic_h36m_graph_train",
           "SYNTHETIC_H36M_MODEL_TRAIN", "synthetic_h36m_model_train",
           "SYNTHETIC_H36M_FAST_GRAPH_TRAIN",
           "synthetic_h36m_fast_graph_train",
           "SYNTHETIC_H36M_ENGINE_TRAIN", "synthetic_h36m_engine_train",
           "SYNTHETIC_H36M_TPU_TRAIN", "synthetic_h36m_tpu_train",
           "SYNTHETIC_H36M_TPU_FUSED", "synthetic_h36m_tpu_fused",
           "REAL_H36M_TRAIN", "real_h36m_train", "REAL_CMU_TRAIN",
           "real_cmu_train", "REAL_3DPW_TRAIN", "real_3dpw_train",
           "set_data_paths"]

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


#: the serving config with the eval step through the whole-encoder kernel
SYNTHETIC_H36M_FUSED = copy.deepcopy(SYNTHETIC_H36M_SERVING)
SYNTHETIC_H36M_FUSED["engine"]["fused_inference"] = True


def synthetic_h36m_fused() -> dict:
    return copy.deepcopy(SYNTHETIC_H36M_FUSED)


#: the serving config's model at full width, trained: 256 train and 64 test
#: sequences, 2 epochs, both DSTD-GC ops through the CUDA kernels
SYNTHETIC_H36M_TRAIN = copy.deepcopy(SYNTHETIC_H36M_SERVING)
SYNTHETIC_H36M_TRAIN.update(epoch=2, mode="train")
SYNTHETIC_H36M_TRAIN["dataset"]["test"]["synthetic"]["num_sequences"] = 64
SYNTHETIC_H36M_TRAIN["model"]["use_pallas"] = True
del SYNTHETIC_H36M_TRAIN["engine"]["fused_inference"]


def synthetic_h36m_train() -> dict:
    return copy.deepcopy(SYNTHETIC_H36M_TRAIN)


#: the training config data parallel over the processes of a launch: each
#: global batch of 32 split over the data axis, BatchNorm statistics,
#: gradients and losses reduced over it (one process: the training config)
SYNTHETIC_H36M_DP_TRAIN = copy.deepcopy(SYNTHETIC_H36M_TRAIN)
SYNTHETIC_H36M_DP_TRAIN["parallel"] = {"data": "auto"}


def synthetic_h36m_dp_train() -> dict:
    return copy.deepcopy(SYNTHETIC_H36M_DP_TRAIN)


#: the training config with the joint axis split over two ranks (the
#: ``graph`` mesh axis) and the data axis over the rest: each rank runs the
#: DSTD-GC ops' kernels on all joints of its data share and keeps its rows
SYNTHETIC_H36M_GRAPH_TRAIN = copy.deepcopy(SYNTHETIC_H36M_TRAIN)
SYNTHETIC_H36M_GRAPH_TRAIN["parallel"] = {"data": "auto", "graph": 2}


def synthetic_h36m_graph_train() -> dict:
    return copy.deepcopy(SYNTHETIC_H36M_GRAPH_TRAIN)


#: the training config with the feature channels split over two ranks (the
#: ``model`` mesh axis, ``param_sharding``'s columns): each rank launches
#: each op's kernels at half the output channels
SYNTHETIC_H36M_MODEL_TRAIN = copy.deepcopy(SYNTHETIC_H36M_TRAIN)
SYNTHETIC_H36M_MODEL_TRAIN["parallel"] = {"data": "auto", "model": 2}


def synthetic_h36m_model_train() -> dict:
    return copy.deepcopy(SYNTHETIC_H36M_MODEL_TRAIN)


#: configs/dstdgcn_fast_multihost.yaml at its own width: the fast variant
#: (16 features, 2 layers, left aggregation) at batch 64, T = 10 + 10, on
#: the plain path, with the joint axis over two ranks
SYNTHETIC_H36M_FAST_GRAPH_TRAIN = copy.deepcopy(SYNTHETIC_H36M_TRAIN)
SYNTHETIC_H36M_FAST_GRAPH_TRAIN.update(
    train_batch_size=64, test_batch_size=64,
    parallel={"data": "auto", "graph": 2,
              "distributed": {"coordinator": "auto"}})
for _split in ("train", "test"):
    SYNTHETIC_H36M_FAST_GRAPH_TRAIN["dataset"][_split]["synthetic"][
        "output_n"] = 10
SYNTHETIC_H36M_FAST_GRAPH_TRAIN["setting"].update(output_n=10,
                                                   eval_frame=[1, 3, 7, 9])
SYNTHETIC_H36M_FAST_GRAPH_TRAIN["model"] = {
    "name": "dstdgcn_fast", "load": False, "ckpt": "None",
    "dstdgcn_fast": {"input_channels": 6, "input_time_frame": 10,
                     "output_time_frame": 10, "st_gcnn_dropout": 0.1,
                     "joints_to_consider": 22, "num_feature": 16,
                     "num_layers": 2, "layout": "h36m"}}


def synthetic_h36m_fast_graph_train() -> dict:
    return copy.deepcopy(SYNTHETIC_H36M_FAST_GRAPH_TRAIN)


#: the training config with the engine's remaining blocks: every DSTD-GC op
#: recomputed in the backward pass (model.dstdgcn.remat), the per-group
#: optimizer (engine.solver), the callback loss CSV (engine.callbacks) and
#: a profiler trace of steps 1-3 (engine.profile, profile_steps)
SYNTHETIC_H36M_ENGINE_TRAIN = copy.deepcopy(SYNTHETIC_H36M_TRAIN)
SYNTHETIC_H36M_ENGINE_TRAIN["model"]["dstdgcn"]["remat"] = True
SYNTHETIC_H36M_ENGINE_TRAIN["engine"].update(
    solver={"optimizer_name": "adam", "bias_lr_factor": 2.0,
            "weight_decay": 1.e-4, "weight_decay_bias": 0.0},
    callbacks={"name": "train", "loss_freq": 1, "window": 100},
    profile="runs/profile", profile_steps=3)


def synthetic_h36m_engine_train() -> dict:
    return copy.deepcopy(SYNTHETIC_H36M_ENGINE_TRAIN)


#: the flagship TPU configuration's model and engine blocks
#: (configs/dstdgcn_h36m_tpu.yaml) trained at batch 128, where the "auto"
#: knobs resolve to bf16: 512 train and 128 test sequences, 2 epochs
SYNTHETIC_H36M_TPU_TRAIN = copy.deepcopy(SYNTHETIC_H36M_TRAIN)
SYNTHETIC_H36M_TPU_TRAIN.update(train_batch_size=128, test_batch_size=128)
SYNTHETIC_H36M_TPU_TRAIN["dataset"]["train"]["synthetic"][
    "num_sequences"] = 512
SYNTHETIC_H36M_TPU_TRAIN["dataset"]["test"]["synthetic"][
    "num_sequences"] = 128
SYNTHETIC_H36M_TPU_TRAIN["model"]["dstdgcn"].update(
    compute_dtype="auto", agg_group_spatial="auto", agg_group_temporal="auto",
    pair_flat=False, remat=False)
SYNTHETIC_H36M_TPU_TRAIN["engine"] = dict(
    prng_impl="rbg", **SYNTHETIC_H36M_TPU_TRAIN["engine"],
    fused_inference=False)


def synthetic_h36m_tpu_train() -> dict:
    return copy.deepcopy(SYNTHETIC_H36M_TPU_TRAIN)


#: the flagship TPU configuration's model and engine blocks served at batch
#: 128 ("auto" resolves to bf16) through the fused-inference path
#: (engine.fused_inference): 512 test sequences, one evaluation sweep
SYNTHETIC_H36M_TPU_FUSED = copy.deepcopy(SYNTHETIC_H36M_TPU_TRAIN)
SYNTHETIC_H36M_TPU_FUSED.update(epoch=1, mode="test")
SYNTHETIC_H36M_TPU_FUSED["dataset"]["test"]["synthetic"][
    "num_sequences"] = 512
SYNTHETIC_H36M_TPU_FUSED["engine"].update(max_iter=2000,
                                          fused_inference=True)


def synthetic_h36m_tpu_fused() -> dict:
    return copy.deepcopy(SYNTHETIC_H36M_TPU_FUSED)


def _real(runner, dataset, setting, model, max_iter=8):
    """A real-data config: the shipped config's blocks at full width with
    every DSTD-GC op through the CUDA kernels, 2 epochs of ``max_iter``
    steps."""
    return {
        "runner": runner,
        "save": copy.deepcopy(SYNTHETIC_H36M_SERVING["save"]),
        "train_batch_size": 32,
        "test_batch_size": 32,
        "num_workers": 0,
        "epoch": 2,
        "mode": "train",
        "dataset": dataset,
        "setting": setting,
        "model": {"name": "dstdgcn", "load": False, "ckpt": "None",
                  "use_pallas": True, "dstdgcn": model},
        "engine": {
            "learn": {"opt": "adam", "lr": 3.e-3, "weight_decay": 0,
                      "gamma": 0.9, "step_size": 5},
            "loss": {"joint": ["jl2", 1]},
            "n_out": 1,
            "transform": "tsc",
            "use_weight": False,
            "inverse": True,
            "max_iter": max_iter,
        },
    }


def _model(output_n, joints, layout):
    return {"input_channels": 6, "input_time_frame": 10,
            "output_time_frame": output_n, "st_gcnn_dropout": 0.1,
            "joints_to_consider": joints, "num_feature": 64,
            "num_layers": 5, "layout": layout}


_H36M_SPLIT = dict(input_n=10, output_n=25, dct_used=0, sample_rate=2,
                   data_3d=True)

#: configs/dstdgcn_h36m.yaml's blocks: T = 35, V = 22
REAL_H36M_TRAIN = _real(
    "h36m",
    {"name": "h36m", "scale": False,
     "train": {"h36m": dict(data_path="data/h36m", actions="all",
                            **_H36M_SPLIT, mode="train", mirror=True)},
     "test": {"h36m": dict(data_path="data/h36m/", **_H36M_SPLIT,
                           mode="test", test_mode="all", mirror=False)}},
    {k: copy.deepcopy(v) for k, v in SYNTHETIC_H36M_SERVING[
        "setting"].items()},
    _model(25, 22, "h36m"))

_CMU_SPLIT = dict(actions="all", input_n=10, output_n=25, dct_used=0,
                  sample_rate=2, data_3d=True, test_mode="all")

#: configs/dstdgcn_cmu.yaml's blocks: T = 35, V = 25
REAL_CMU_TRAIN = _real(
    "cmu",
    {"name": "cmu", "scale": False,
     "train": {"cmu": dict(data_path="data/cmu/train", **_CMU_SPLIT,
                           mirror=True)},
     "test": {"cmu": dict(data_path="data/cmu/test", **_CMU_SPLIT,
                          mirror=False)}},
    {"input_n": 10, "output_n": 25,
     "eval_frame": [1, 3, 7, 9, 13, 17, 21, 24],
     "dim_used": [9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 27, 28, 29,
                  30, 31, 32, 33, 34, 35, 36, 37, 38, 42, 43, 44, 45, 46, 47,
                  51, 52, 53, 54, 55, 56, 57, 58, 59, 63, 64, 65, 66, 67, 68,
                  69, 70, 71, 75, 76, 77, 78, 79, 80, 84, 85, 86, 90, 91, 92,
                  93, 94, 95, 96, 97, 98, 102, 103, 104, 105, 106, 107, 111,
                  112, 113],
     "joint_to_ignore": [16, 20, 29, 24, 27, 33, 36],
     "joint_to_equal": [15, 15, 15, 23, 23, 32, 32],
     "save": False},
    _model(25, 25, "cmu"))

_PW3D_SPLIT = dict(input_n=10, output_n=30, dct_used=0)

#: configs/dstdgcn_3dpw.yaml's blocks: T = 40, V = 23
REAL_3DPW_TRAIN = _real(
    "3dpw",
    {"name": "3dpw", "scale": False,
     "train": {"3dpw": dict(data_path="data/3dpw/sequenceFiles/train/",
                            **_PW3D_SPLIT, mirror=True, padding=True)},
     "test": {"3dpw": dict(data_path="data/3dpw/sequenceFiles/test/",
                           **_PW3D_SPLIT, mirror=False, padding=True)}},
    {"input_n": 10, "output_n": 30, "eval_frame": [4, 9, 14, 19, 24],
     "dim_used": list(range(3, 72)), "joint_to_ignore": None,
     "joint_to_equal": None, "save": False},
    _model(30, 23, "3dpw"))


def real_h36m_train() -> dict:
    return copy.deepcopy(REAL_H36M_TRAIN)


def real_cmu_train() -> dict:
    return copy.deepcopy(REAL_CMU_TRAIN)


def real_3dpw_train() -> dict:
    return copy.deepcopy(REAL_3DPW_TRAIN)


def set_data_paths(cfg: dict, train: str, test: str) -> dict:
    """Point a real-data config's train and test splits at ``train`` and
    ``test``; returns ``cfg``."""
    name = cfg["dataset"]["name"]
    cfg["dataset"]["train"][name]["data_path"] = train
    cfg["dataset"]["test"][name]["data_path"] = test
    return cfg
