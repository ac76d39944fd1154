"""Per-action runner for Human3.6M and CMU Mocap.

Counterpart of ``dstdgcn_tpu/runner/action_runner.py``: train an epoch,
evaluate every action at the configured horizons, append a row to
``training_loss.csv``, write the ``last`` and ``best`` checkpoints, and
append the best row at the end; the test modes write ``testing_loss.csv``
with per-action per-horizon columns (``test``) or one row per action and an
``average`` row over every output frame (``test-all``).  The CSV files
carry the JAX runner's headers and columns and are written with the
``csv`` module.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, List

import numpy as np

from ..data import Loader, define_actions, get_dataset
from .base import BaseRunner

__all__ = ["ActionRunner", "H36MRunner", "CMURunner"]

_HORIZON_HEADS_LONG = ["3d80", "3d160", "3d320", "3d400", "3d560", "3d720",
                       "3d880", "3d1000"]
_HORIZON_HEADS_SHORT = ["3d80", "3d160", "3d320", "3d400"]


def _optional(setting, key):
    value = setting.get(key)
    return None if value is None else np.array(value)


class ActionRunner(BaseRunner):

    def _horizon_heads(self) -> List[str]:
        return (_HORIZON_HEADS_LONG
                if self.config["setting"]["output_n"] > 10
                else _HORIZON_HEADS_SHORT)

    def _test_actions(self) -> List[str]:
        debug = "debug" in self.config["mode"]
        return define_actions("debug" if debug else "all",
                              self.config["dataset"]["name"])

    def _train_dataset(self, scale=None):
        """The train split (``scale`` set into its options when given);
        its build time in ``data_seconds["train"]``."""
        cfg = self.config
        name = cfg["dataset"]["name"]
        train_cfg = cfg["dataset"]["train"]
        if scale is not None:
            train_cfg[name]["scale"] = scale
        t0 = time.perf_counter()
        ds = get_dataset(name, **train_cfg)
        self.data_seconds["train"] = time.perf_counter() - t0
        return ds

    def _build_test_loaders(self, test_acts, scaler=None) -> Dict[str, Loader]:
        name = self.config["dataset"]["name"]
        test_cfg = self.config["dataset"]["test"]
        loaders = {}
        t0 = time.perf_counter()
        for act in test_acts:
            test_cfg[name]["actions"] = act
            if scaler is not None:
                test_cfg[name]["scaler"] = scaler
            ds = get_dataset(name, **test_cfg)
            loaders[act] = self._loader(ds, self.config["test_batch_size"],
                                        shuffle=False)
            self._last_test_dataset = ds
        self.data_seconds["test"] = time.perf_counter() - t0
        return loaders

    def _eval_all_actions(self, test_acts, loaders, time_tsfm, scale_tsfm,
                          save_prefix=None):
        """Evaluate every action; returns (average loss, per-horizon
        average, the row ``[test_loss, horizons, each action's horizons]``,
        its header).  ``test_batch_seconds`` holds every batch's seconds."""
        setting = self.config["setting"]
        heads = self._horizon_heads()
        err_avg, err_all = 0.0, np.zeros(len(heads))
        ret = np.zeros(1 + len(heads))
        head = ["test_loss"] + heads
        self.test_batch_seconds = []
        for act in test_acts:
            a_avg, a_all = self.engine.test(
                loaders[act], setting["input_n"],
                np.array(setting["eval_frame"]),
                np.array(setting["dim_used"]),
                _optional(setting, "joint_to_ignore"),
                _optional(setting, "joint_to_equal"),
                time_tsfm, scale_tsfm, act,
                (save_prefix + act) if save_prefix else None)
            self.test_batch_seconds += self.engine.test_batch_seconds
            err_avg += a_avg
            err_all += a_all
            ret = np.append(ret, a_all)
            head += [act + h for h in heads]
        err_avg /= len(test_acts)
        err_all /= len(test_acts)
        ret[0] = err_avg
        ret[1:len(err_all) + 1] = err_all
        return err_avg, err_all, ret, head

    def run_train(self):
        """Train ``epoch`` epochs with a per-action eval after each; returns
        the per-epoch rows of ``training_loss.csv``."""
        self.logger.info("Start training")
        cfg = self.config
        name = cfg["dataset"]["name"]
        debug = "debug" in cfg["mode"]
        test_acts = self._test_actions()
        train_cfg = cfg["dataset"]["train"]
        train_cfg[name]["actions"] = "debug" if debug else "all"
        if "mode" in train_cfg[name]:
            train_cfg[name]["mode"] = "debug" if debug else "train"
        train_dataset = self._train_dataset()
        self.logger.info(
            "train data shape {}".format(train_dataset.all_seqs.shape[0]))
        train_loader = self._loader(train_dataset, cfg["train_batch_size"],
                                    shuffle=True)
        test_loaders = self._build_test_loaders(
            test_acts, scaler=train_dataset.scale_tsfm)

        self.engine.init()
        if cfg["model"].get("load"):
            start_epoch, err_best = self.engine.recover(cfg["model"]["ckpt"])
        else:
            start_epoch, err_best = 0, 1e10

        ret_log_best = None
        history = []
        for epoch in range(start_epoch, cfg["epoch"]):
            self.logger.info("==========================")
            self.logger.info(">>> epoch: {} | lr: {:.5f}".format(
                epoch + 1, self.engine.lr_schedule(epoch)))
            train_loader.set_epoch(epoch)
            train_loss = self.engine.train(
                train_loader, epoch, train_dataset.time_tsfm,
                train_dataset.scale_tsfm,
                (train_dataset.joint_weight_use
                 if cfg["engine"]["use_weight"] else None),
                cfg["engine"]["max_iter"])

            err_avg, _, ret_test, head_test = self._eval_all_actions(
                test_acts, test_loaders, train_dataset.time_tsfm,
                train_dataset.scale_tsfm)

            ret_log = np.concatenate(
                [[epoch + 1, self.engine.lr, train_loss], ret_test])
            head = ["epoch", "lr", "train_loss"] + head_test
            self._append_csv("training_loss.csv", ret_log,
                             head if epoch == start_epoch else None)
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
            self._append_csv("training_loss.csv", ret_log_best, None)
        return history

    def _scaler(self):
        """The train split's scaler when ``dataset.scale`` is set (the
        test splits are scaled by the train statistics), else None."""
        if not self.config["dataset"].get("scale"):
            return None
        return self._train_dataset(scale=True).scale_tsfm

    def _load_for_test(self, test_acts, scale_test=True):
        """The test loaders, the last test dataset, and the engine with
        the configured checkpoint.  With ``dataset.scale`` the test splits
        get the train scaler; ``scale_test`` False leaves their own
        ``scale`` option as configured, as the JAX runner's ``test-all``
        does."""
        scaler = self._scaler()
        if scaler is not None and scale_test:
            name = self.config["dataset"]["name"]
            self.config["dataset"]["test"][name]["scale"] = True
        test_loaders = self._build_test_loaders(test_acts, scaler=scaler)
        self.engine.init()
        if self.config["model"].get("load"):
            self.engine.recover(self.config["model"]["ckpt"],
                                model_only=True)
        return test_loaders, self._last_test_dataset

    def _save_prefix(self):
        cfg = self.config
        return (cfg["save"]["path"]["visualize"]
                if cfg["setting"].get("save") else None)

    def run_test(self):
        """Evaluate every action once; writes ``testing_loss.csv`` (one row:
        test_loss, the horizons, each action's horizons) and returns
        ``(average loss, that row)``."""
        self.logger.info("Start testing")
        test_acts = self._test_actions()
        test_loaders, ds = self._load_for_test(test_acts)
        err_avg, _, ret_test, head_test = self._eval_all_actions(
            test_acts, test_loaders, ds.time_tsfm, ds.scale_tsfm,
            self._save_prefix())
        self.logger.info("Loss: {:.5f}".format(err_avg))
        out = self._write_csv("testing_loss.csv", head_test, [ret_test])
        self.logger.info("Save result to " + out)
        return err_avg, ret_test

    def run_test_all(self):
        """The metric at every output frame, per action: writes
        ``testing_loss.csv`` (action, avg, one column per 40 ms frame; an
        ``average`` row weighted by each action's batches) and returns its
        rows."""
        self.logger.info("Start testing all")
        cfg = self.config
        test_acts = self._test_actions()
        test_loaders, ds = self._load_for_test(test_acts, scale_test=False)
        setting = cfg["setting"]
        output_n = setting["output_n"]
        head = ["action", "avg"] + [str((i + 1) * 40) for i in range(output_n)]
        rows = []
        accum_avg, accum_all, total = 0.0, np.zeros(output_n), 0
        save_prefix = self._save_prefix()
        for act in test_acts:
            a_avg, a_all = self.engine.test(
                test_loaders[act], setting["input_n"], np.arange(output_n),
                np.array(setting["dim_used"]),
                _optional(setting, "joint_to_ignore"),
                _optional(setting, "joint_to_equal"),
                ds.time_tsfm, ds.scale_tsfm, act,
                (save_prefix + act) if save_prefix else None)
            w = len(test_loaders[act])
            accum_avg += a_avg * w
            accum_all += a_all * w
            total += w
            rows.append([act, a_avg] + list(a_all))
        rows.append(["average", accum_avg / total] +
                    list(accum_all / total))
        out = self._write_csv("testing_loss.csv", head, rows)
        self.logger.info("Loss: {:.5f}".format(accum_avg / total))
        self.logger.info("Save result to " + out)
        return rows

    def _write_csv(self, filename, head, rows, mode="w"):
        """Write ``rows`` (after ``head``) into the run directory's
        ``filename``, on the writing process only; returns its path."""
        out = os.path.join(self.config["save"]["path"]["base"], filename)
        if not self.writes:
            return out
        with open(out, mode, newline="") as f:
            writer = csv.writer(f)
            if head is not None:
                writer.writerow(head)
            for row in rows:
                writer.writerow([v if isinstance(v, str) else float(v)
                                 for v in row])
        return out

    def _append_csv(self, filename, row, head):
        """A row, after the header when ``head`` is given (the file is then
        started anew)."""
        self._write_csv(filename, head, [row],
                        "w" if head is not None else "a")


class H36MRunner(ActionRunner):
    pass


class CMURunner(ActionRunner):
    pass
