"""Experiment runners: datasets, engine and evaluation, by mode.

Counterpart of ``dstdgcn_tpu/runner/base.py::BaseRunner``: builds the model
and engine for the train/test modes (``engine.callbacks`` writes into the
run directory unless its ``log_dir`` says otherwise), snapshots source
files into the run directory, seeds numpy and ``random`` with 777 and
dispatches on ``mode``; the visualize modes render test sequences
(:meth:`BaseRunner.run_visualize`).
"""

from __future__ import annotations

import os
import random
import shutil

import numpy as np
import torch

from ..data import define_actions, get_dataset
from ..engine import PredictionEngine
from ..models import get_model

__all__ = ["BaseRunner", "setup_seed"]


def setup_seed(seed: int) -> None:
    np.random.seed(seed)
    random.seed(seed)


class BaseRunner:
    """Builds model + engine (train/test modes) and dispatches on mode."""

    def __init__(self, config, device: str | torch.device = "cuda"):
        self.config = config
        self.logger = config["logger"]
        self.dataset = config["dataset"]["name"]
        self.engine = None
        #: host seconds of each dataset build of the run ("train", "test")
        self.data_seconds = {}
        #: host seconds of each batch of the last evaluation sweep
        self.test_batch_seconds = []
        if "t" in self.config["mode"]:
            model_opts = {k: v for k, v in dict(config["model"]).items()
                          if k != "name"}
            model_name = config["model"]["name"]
            # pin "auto" knob resolution to the configured train batch so
            # that a ragged last batch or an eval batch of another size does
            # not flip the knobs within a run (models/autotune.py)
            knobs = list(dict(model_opts.get(model_name, {})).values()) \
                + list(model_opts.values())
            if any(isinstance(v, str) and v == "auto" for v in knobs):
                model_opts.setdefault(
                    "auto_batch_hint", int(config["train_batch_size"]))
            model = get_model(model_name, **model_opts)
            if config["engine"].get("callbacks"):
                config["engine"]["callbacks"].setdefault(
                    "log_dir", config["save"]["path"]["base"])
            self.engine = PredictionEngine(config["engine"], model,
                                           self.logger, device=device)
        self.save_files()
        setup_seed(777)

    def save_files(self) -> None:
        for path in list(self.config["save"]["path"].keys()):
            if path != "base":
                update = os.path.join(self.config["save"]["path"]["base"],
                                      self.config["save"]["path"][path])
                self.config["save"]["path"][path] = update
                os.makedirs(update, exist_ok=True)
        for file in self.config["save"].get("files", []):
            if os.path.exists(file):
                shutil.copy(file, self.config["save"]["path"]["files"])

    def run(self):
        mode = self.config["mode"]
        if "train" in mode:
            return self.run_train()
        if "test" in mode:
            if "visualize" in mode:
                self.config["setting"]["save"] = True
            if "all" in mode:
                return self.run_test_all()
            return self.run_test()
        return self.run_visualize()

    def run_train(self):
        raise NotImplementedError

    def run_test(self):
        raise NotImplementedError

    def run_test_all(self):
        raise NotImplementedError

    def run_visualize(self):
        """Render the first 8 test sequences of each action (the debug
        action in a ``-debug`` mode, else all) into the visualize
        directory: ``A<action>_S<i>.gif`` and ``.png``
        (:meth:`..utils.visualization.Visualizer.plot_single`); nothing is
        written without matplotlib and imageio."""
        from ..utils.visualization import Visualizer
        dataset_name = self.config["dataset"]["name"]
        train_cfg = self.config["dataset"]["train"]
        if "debug" in self.config["mode"]:
            test_acts = define_actions("debug", dataset_name)
            train_cfg[dataset_name]["actions"] = "debug"
        else:
            test_acts = define_actions("all", dataset_name)
            train_cfg[dataset_name]["actions"] = "all"
        train_dataset = get_dataset(dataset_name, **train_cfg)
        test_cfg = self.config["dataset"]["test"]
        test_cfg[dataset_name]["scaler"] = train_dataset.scale_tsfm
        vis = Visualizer(self.dataset)
        for act in test_acts:
            test_cfg[dataset_name]["actions"] = act
            test_dataset = get_dataset(dataset_name, **test_cfg)
            for i in range(len(test_dataset)):
                seq = test_dataset.all_seqs[i]
                vis.plot_single(seq, self.config["save"]["path"]["visualize"],
                                f"A{act}_S{i + 1}",
                                self.config["setting"]["input_n"])
                if i + 1 >= 8:
                    break
