"""Traffic-forecasting runner: Graph WaveNet on a seeded traffic series.

The ``dataset`` block's ``traffic`` entry draws the series
(:func:`..data.traffic.traffic_series`: ``days`` of 5-minute steps at
``seed``, a share ``missing`` of zero readings) for the model's sensors,
splits its windows 6 : 2 : 2 and z-scores the reading by the training
inputs (:func:`..data.traffic.split_windows`).  ``run_train`` trains
``epoch`` epochs through ``PredictionEngine.train``, the loss the
configured one on the de-normalised prediction (``mmae``), evaluates the
validation windows after each and appends a row to ``training_loss.csv``
(epoch, lr, train loss, the masked MAE over every step ahead and at steps
3, 6 and 12), writes the ``last`` and ``best`` checkpoints, then appends
the best row; ``run_test`` writes the test windows' row to
``testing_loss.csv``.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from ..data import Loader, traffic
from ..engine.losses import masked_mae_error
from .base import BaseRunner

__all__ = ["ForecastRunner"]

#: the steps ahead reported beside the mean over all of them
HORIZONS = (3, 6, 12)


class ForecastRunner(BaseRunner):

    def _data(self):
        cfg = self.config
        ds = dict(cfg["dataset"]["traffic"])
        hp = cfg["model"][cfg["model"]["name"]]
        steps = int(ds["days"] * traffic.STEPS_PER_DAY)
        series = traffic.traffic_series(int(hp["joints_to_consider"]), steps,
                                        int(ds.get("seed", 0)),
                                        float(ds.get("missing", 0.05)))
        return traffic.split_windows(series, int(hp["input_time_frame"]),
                                     int(hp["output_time_frame"]))

    def _split_loader(self, split, batch_size) -> Loader:
        x, y = split
        # (inputs, inverse inputs (unused), targets, targets)
        return Loader((x, np.zeros((len(x), 0), np.float32), y, y),
                      batch_size, shuffle=True)

    def _heads(self):
        return ["test_loss"] + [f"mae{h}" for h in HORIZONS]

    @torch.inference_mode()
    def _evaluate(self, split, scaler) -> np.ndarray:
        """Masked MAE over every step ahead and at each of ``HORIZONS``,
        over the windows of ``split``."""
        x, y = split
        bs = int(self.config["test_batch_size"])
        preds = [self.engine.predict(x[i:i + bs], None, scaler)
                 for i in range(0, len(x), bs)]
        pred = torch.cat(preds)
        y = self.engine.to_device(y)
        row = [masked_mae_error(pred, y)]
        row += [masked_mae_error(pred[:, h - 1], y[:, h - 1])
                for h in HORIZONS if h <= y.shape[1]]
        return np.asarray([float(v) for v in row])

    def _write(self, name, rows, head) -> None:
        if not self.writes:
            return
        path = os.path.join(self.config["save"]["path"]["base"], name)
        with open(path, "w" if head else "a", newline="") as f:
            writer = csv.writer(f)
            if head:
                writer.writerow(head)
            for row in rows:
                writer.writerow([float(v) for v in row])

    def run_train(self):
        """Train ``epoch`` epochs with a validation sweep after each;
        returns the per-epoch rows of ``training_loss.csv``."""
        self.logger.info("Start training")
        cfg = self.config
        splits, scaler = self._data()
        loader = self._split_loader(splits["train"], cfg["train_batch_size"])
        self.logger.info(f"train windows {len(splits['train'][0])}")
        self.engine.init()
        start, best = 0, float("inf")
        if cfg["model"].get("load"):
            start, best = self.engine.recover(cfg["model"]["ckpt"])
        head = ["epoch", "lr", "train_loss"] + self._heads()
        history, best_row = [], None
        for epoch in range(start, cfg["epoch"]):
            loader.set_epoch(epoch)
            loss = self.engine.train(loader, epoch, None, scaler, None,
                                     cfg["engine"]["max_iter"])
            metrics = self._evaluate(splits["val"], scaler)
            row = np.concatenate([[epoch + 1, self.engine.lr, loss],
                                  metrics])
            self._write("training_loss.csv", [row],
                        head if epoch == start else None)
            history.append(row)
            is_best = bool(np.isfinite(metrics[0]) and metrics[0] < best)
            if is_best:
                best, best_row = float(metrics[0]), row
            self.engine.save(cfg["save"]["path"]["checkpoints"],
                             float(metrics[0]), epoch, is_best)
            self.logger.info(f">>> epoch: {epoch + 1} | val mae: "
                             f"{metrics[0]:.4f} | best: {best:.4f}")
        if best_row is not None:
            self._write("training_loss.csv", [best_row], None)
        return history

    def run_test(self):
        """Evaluate the test windows once; writes ``testing_loss.csv`` and
        returns its row."""
        cfg = self.config
        splits, scaler = self._data()
        self.engine.init()
        if cfg["model"].get("load"):
            self.engine.recover(cfg["model"]["ckpt"], model_only=True)
        row = self._evaluate(splits["test"], scaler)
        self._write("testing_loss.csv", [row], self._heads())
        return row
