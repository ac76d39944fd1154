"""Single-split runner for 3DPW and the synthetic dataset.

Counterpart of ``dstdgcn_tpu/runner/simple_runner.py``: one test loader (no
per-action split).  ``run_train`` trains epoch by epoch, evaluates after
each, appends a row to ``training_loss.csv`` and writes the ``last`` and
``best`` checkpoints, then appends the best row; ``run_test`` writes
``testing_loss.csv``; ``run_visualize`` renders every test sequence.  The
CSV files are written with the ``csv`` module, by the writing process only
(rank 0 of a multi-process launch).
"""

from __future__ import annotations

import csv
import os
import time

import numpy as np

from ..data import get_dataset
from .base import BaseRunner

__all__ = ["SimpleRunner", "PW3DRunner", "SyntheticRunner"]


class SimpleRunner(BaseRunner):

    def _heads(self):
        frames = self.config["setting"]["eval_frame"]
        return ["test_loss"] + [f"3d{(f + 1) * 40}" for f in frames]

    def _test_once(self, test_loader, ds, save_path=None):
        setting = self.config["setting"]
        jti = setting.get("joint_to_ignore")
        jte = setting.get("joint_to_equal")
        result = self.engine.test(
            test_loader, setting["input_n"], np.array(setting["eval_frame"]),
            np.array(setting["dim_used"]),
            np.array(jti) if jti is not None else None,
            np.array(jte) if jte is not None else None,
            ds.time_tsfm, None, "all", save_path)
        self.test_batch_seconds = list(self.engine.test_batch_seconds)
        return result

    def _append_row(self, row, head=None):
        if not self.writes:
            return
        out = os.path.join(self.config["save"]["path"]["base"],
                           "training_loss.csv")
        with open(out, "w" if head else "a", newline="") as f:
            writer = csv.writer(f)
            if head:
                writer.writerow(head)
            writer.writerow([float(v) for v in row])

    def run_train(self):
        """Train ``epoch`` epochs with an eval sweep after each; returns the
        per-epoch rows of ``training_loss.csv`` (epoch, lr, train loss,
        test loss, per-eval-frame metrics)."""
        self.logger.info("Start training")
        cfg = self.config
        name = cfg["dataset"]["name"]
        t0 = time.perf_counter()
        train_dataset = get_dataset(name, **cfg["dataset"]["train"])
        t1 = time.perf_counter()
        self.logger.info("train data shape {}".format(len(train_dataset)))
        train_loader = self._loader(train_dataset, cfg["train_batch_size"],
                                    shuffle=True)
        test_dataset = get_dataset(name, **cfg["dataset"]["test"])
        self.data_seconds = dict(train=t1 - t0,
                                 test=time.perf_counter() - t1)
        self.logger.info("test data shape {}".format(len(test_dataset)))
        test_loader = self._loader(test_dataset, cfg["test_batch_size"],
                                   shuffle=False)

        self.engine.init()
        if cfg["model"].get("load"):
            start_epoch, err_best = self.engine.recover(cfg["model"]["ckpt"])
        else:
            start_epoch, err_best = 0, 1e10

        head = ["epoch", "lr", "train_loss"] + self._heads()
        ret_log_best = None
        history = []
        for epoch in range(start_epoch, cfg["epoch"]):
            self.logger.info("==========================")
            self.logger.info(">>> epoch: {} | lr: {:.5f}".format(
                epoch + 1, self.engine.lr_schedule(epoch)))
            train_loader.set_epoch(epoch)
            train_loss = self.engine.train(
                train_loader, epoch, train_dataset.time_tsfm, None, None,
                cfg["engine"]["max_iter"])
            err_avg, err_all = self._test_once(test_loader, test_dataset)

            ret_log = np.concatenate([[epoch + 1, self.engine.lr,
                                       train_loss], [err_avg], err_all])
            self._append_row(ret_log, head if epoch == start_epoch else None)
            history.append(ret_log)

            is_best = (not np.isnan(err_avg)) and err_avg < err_best
            if not np.isnan(err_avg):
                err_best = min(err_avg, err_best)
            self.engine.save(cfg["save"]["path"]["checkpoints"], err_avg,
                             epoch, is_best)
            if is_best:
                ret_log_best = ret_log
            self.logger.info(
                ">>> epoch: {} | loss: {:.5f} | best: {:.5f}".format(
                    epoch + 1, err_avg, err_best))

        if ret_log_best is not None:
            self._append_row(ret_log_best)
        return history

    def run_test(self):
        """Evaluate once; writes ``testing_loss.csv`` and returns
        ``(avg, per-eval-frame metrics)``."""
        self.logger.info("Start testing")
        cfg = self.config
        name = cfg["dataset"]["name"]
        test_dataset = get_dataset(name, **cfg["dataset"]["test"])
        test_loader = self._loader(test_dataset, cfg["test_batch_size"],
                                   shuffle=False)
        self.logger.info(
            "test data shape {}".format(test_dataset.all_seqs.shape[0]))
        self.engine.init()
        if cfg["model"].get("load"):
            self.engine.recover(cfg["model"]["ckpt"], model_only=True)
        save_path = (cfg["save"]["path"]["visualize"] + "all"
                     if cfg["setting"].get("save") else None)
        err_avg, err_all = self._test_once(test_loader, test_dataset,
                                           save_path)
        self.logger.info("Loss: {:.5f}".format(err_avg))
        out = os.path.join(cfg["save"]["path"]["base"], "testing_loss.csv")
        if self.writes:
            with open(out, "w", newline="") as f:
                writer = csv.writer(f)
                writer.writerow(self._heads())
                writer.writerow([float(err_avg)]
                                + [float(e) for e in err_all])
        self.logger.info("Save result to " + out)
        return err_avg, err_all

    def run_test_all(self):
        raise NotImplementedError("test-all is defined for the per-action "
                                  "datasets (h36m, cmu), as in the JAX "
                                  "package")


    def run_visualize(self):
        """Render every test sequence into the visualize directory:
        ``S<i>.gif`` and ``.png`` (nothing without matplotlib and
        imageio)."""
        from ..utils.visualization import Visualizer
        cfg = self.config
        name = cfg["dataset"]["name"]
        test_dataset = get_dataset(name, **cfg["dataset"]["test"])
        vis = Visualizer(self.dataset)
        for i in range(len(test_dataset)):
            vis.plot_single(test_dataset.all_seqs[i],
                            cfg["save"]["path"]["visualize"],
                            f"S{i + 1}", cfg["setting"]["input_n"])


class PW3DRunner(SimpleRunner):
    pass


class SyntheticRunner(SimpleRunner):
    pass
