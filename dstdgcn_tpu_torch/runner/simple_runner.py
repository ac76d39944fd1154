"""Single-split runner for the synthetic dataset.

Counterpart of ``dstdgcn_tpu/runner/simple_runner.py``: one test loader (no
per-action split) and a ``testing_loss.csv`` with the average and the
per-horizon metrics, written with the ``csv`` module.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ..data import Loader, get_dataset
from .base import BaseRunner

__all__ = ["SimpleRunner", "SyntheticRunner"]


class SimpleRunner(BaseRunner):

    def _heads(self):
        frames = self.config["setting"]["eval_frame"]
        return ["test_loss"] + [f"3d{(f + 1) * 40}" for f in frames]

    def _test_once(self, test_loader, ds, save_path=None):
        setting = self.config["setting"]
        jti = setting.get("joint_to_ignore")
        jte = setting.get("joint_to_equal")
        return self.engine.test(
            test_loader, setting["input_n"], np.array(setting["eval_frame"]),
            np.array(setting["dim_used"]),
            np.array(jti) if jti is not None else None,
            np.array(jte) if jte is not None else None,
            ds.time_tsfm, None, "all", save_path)

    def run_test(self):
        """Evaluate once; writes ``testing_loss.csv`` and returns
        ``(avg, per-eval-frame metrics)``."""
        self.logger.info("Start testing")
        cfg = self.config
        name = cfg["dataset"]["name"]
        test_dataset = get_dataset(name, **cfg["dataset"]["test"])
        test_loader = Loader(test_dataset.arrays(), cfg["test_batch_size"],
                             shuffle=False)
        self.logger.info(
            "test data shape {}".format(test_dataset.all_seqs.shape[0]))
        self.engine.init()
        if cfg["model"].get("load"):
            raise NotImplementedError(
                "model.load: reading the JAX package's msgpack checkpoints "
                "is not ported yet (ROADMAP Queue 1 item 6)")
        save_path = (cfg["save"]["path"]["visualize"] + "all"
                     if cfg["setting"].get("save") else None)
        err_avg, err_all = self._test_once(test_loader, test_dataset,
                                           save_path)
        self.logger.info("Loss: {:.5f}".format(err_avg))
        out = os.path.join(cfg["save"]["path"]["base"], "testing_loss.csv")
        with open(out, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(self._heads())
            writer.writerow([float(err_avg)] + [float(e) for e in err_all])
        self.logger.info("Save result to " + out)
        return err_avg, err_all


class SyntheticRunner(SimpleRunner):
    pass
