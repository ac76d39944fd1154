"""Experiment runners: datasets, engine and evaluation, by mode.

Counterpart of ``dstdgcn_tpu/runner/base.py::BaseRunner``: builds the model
and engine for the train/test modes (``engine.callbacks`` writes into the
run directory unless its ``log_dir`` says otherwise), snapshots source
files into the run directory, seeds numpy and ``random`` with 777 and
dispatches on ``mode``; the visualize modes render test sequences
(:meth:`BaseRunner.run_visualize`).  The optional ``parallel`` block
(``data``, ``graph``, ``model``) builds the process mesh by the JAX
runner's rules (:meth:`BaseRunner._build_mesh`), and every loader takes
this process's share of each global batch (:meth:`BaseRunner._loader`).
"""

from __future__ import annotations

import os
import random
import shutil

import numpy as np
import torch
import torch.distributed as dist

from ..data import Loader, define_actions, get_dataset
from ..engine import PredictionEngine
from ..models import get_model
from ..parallel.distributed import process_info
from ..parallel.mesh import activation_sharding_context, make_mesh

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
        #: whether this process writes the run's files (rank 0)
        self.writes = process_info()[0] == 0
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
            mesh = self._build_mesh()
            with activation_sharding_context(mesh):
                model = get_model(model_name, **model_opts)
            if config["engine"].get("callbacks"):
                config["engine"]["callbacks"].setdefault(
                    "log_dir", config["save"]["path"]["base"])
            self.engine = PredictionEngine(config["engine"], model,
                                           self.logger, device=device,
                                           mesh=mesh)
        self.save_files()
        setup_seed(777)

    def _build_mesh(self):
        """The process mesh of the ``parallel`` block, resolved as the JAX
        runner resolves it with the world size in place of the device
        count: ``data: auto`` is the world over graph x model; a world that
        graph x model does not divide drops both to 1; a mesh larger than
        the world warns and runs single-device.  None without the block or
        without a process group (one process: nothing to reduce).  Under
        several processes the mesh must hold every rank (a ``ValueError``
        otherwise)."""
        par = self.config.get("parallel")
        if not par or not dist.is_initialized():
            return None
        graph = int(par.get("graph", 1))
        model = int(par.get("model", 1))
        data = par.get("data", "auto")
        data = None if data in ("auto", None, "None") else int(data)
        world = dist.get_world_size()
        if data is None and world % (graph * model) != 0:
            graph = model = 1
        size = (data or (world // (graph * model))) * graph * model
        if size != world and world > 1:
            raise ValueError(f"parallel: a mesh of {size} ranks "
                             f"({data}x{graph}x{model}) over {world} "
                             "processes: every process must be a rank")
        if size > world:
            self.logger.warning(
                f"parallel config requests {data}x{graph}x{model} ranks, "
                f"have {world}; falling back to single-device")
            return None
        mesh = make_mesh(data=data, graph=graph, model=model)
        self.logger.info(f"process mesh: {mesh.shape}")
        return mesh

    def _loader(self, dataset, batch_size, shuffle) -> Loader:
        """A loader of ``dataset`` that takes this process's share of
        each global batch of ``batch_size``; ragged last batches are
        dropped under several processes, so that every share is equal."""
        pi, pc = process_info()
        return Loader(dataset.arrays(), batch_size, shuffle=shuffle,
                      drop_last=pc > 1, process_index=pi, process_count=pc)

    def save_files(self) -> None:
        for path in list(self.config["save"]["path"].keys()):
            if path != "base":
                update = os.path.join(self.config["save"]["path"]["base"],
                                      self.config["save"]["path"][path])
                self.config["save"]["path"][path] = update
                os.makedirs(update, exist_ok=True)
        for file in self.config["save"].get("files", []):
            if os.path.exists(file) and self.writes:
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
