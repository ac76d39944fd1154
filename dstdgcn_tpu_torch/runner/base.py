"""Experiment runners: datasets, engine and evaluation, by mode.

Counterpart of ``dstdgcn_tpu/runner/base.py::BaseRunner``: builds the model
and engine for the train/test modes, snapshots source files into the run
directory, seeds numpy and ``random`` with 777 and dispatches on ``mode``.
"""

from __future__ import annotations

import os
import random
import shutil

import numpy as np
import torch

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
        raise NotImplementedError(
            "visualization is not ported yet (ROADMAP Queue 1 item 3)")
