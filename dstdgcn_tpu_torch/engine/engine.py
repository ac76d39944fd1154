"""Prediction engine: model state, the eval step and the evaluation sweep.

Counterpart of ``dstdgcn_tpu/engine/engine.py::PredictionEngine`` for the
serving path: ``init``, ``transform``/``inverse``, the eval step (the
``dim_used`` scatter, the ignore/equal joint fix-up and per-frame MPJPE) and
``test``.  Training (``train``) and the whole-encoder kernel behind
``fused_inference`` are later slices and raise.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..data import transforms as tfm
from ..utils.device import resolve_device
from . import losses as L

__all__ = ["PredictionEngine"]


class PredictionEngine:
    """Owns the model on its device and runs the evaluation protocol.

    ``config`` is the ``engine`` block of the experiment config; the eval
    path reads ``transform`` and refuses ``fused_inference``.
    """

    def __init__(self, config: Dict[str, Any], model: torch.nn.Module,
                 logger=None, device: str | torch.device = "cuda"):
        if config.get("fused_inference", False):
            raise NotImplementedError(
                "engine.fused_inference (the whole-encoder kernel) is not "
                "ported yet (ROADMAP Queue 2 item 4)")
        self.logger = logger
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.transform_fn, self.inverse_fn = tfm.get_transform(
            config.get("transform", "tsc"))
        #: host seconds of each batch of the last :meth:`test`, device work
        #: included (the metric is read back every batch)
        self.test_batch_seconds: List[float] = []

    # -- state ------------------------------------------------------------

    def init(self, seed: int = 777) -> torch.nn.Module:
        """Draw the model's parameters from ``seed`` and set eval mode."""
        gen = torch.Generator().manual_seed(seed)
        self.model.cpu().reset_parameters(gen)
        self.model.to(self.device).eval()
        if self.logger is not None:
            self.logger.info("Trainable number of parameters of the network "
                             f"is: {self.num_params()}")
        return self.model

    def num_params(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    # -- transforms -------------------------------------------------------

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.transform_fn is None else self.transform_fn(x)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.inverse_fn is None else self.inverse_fn(x)

    def to_device(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(
            self.device)

    # -- serving ----------------------------------------------------------

    @torch.inference_mode()
    def predict(self, inputs, time_tsfm=None, scale_tsfm=None) \
            -> torch.Tensor:
        """Model output for flat input sequences ``(N, T, S)`` in the flat
        exchange layout, on the engine's device."""
        self.model.eval()
        x = self.transform(self.to_device(inputs))
        out = self.model(x)
        if isinstance(out, (list, tuple)):   # multi-output: use the last
            out = out[-1]
        out = self.inverse(out)
        if scale_tsfm is not None:
            out = scale_tsfm.inverse(out)
        if time_tsfm is not None:
            out = time_tsfm.inverse(out)
        return out

    @torch.inference_mode()
    def _eval_step(self, inputs, all_seqs, input_n, eval_frame, dim_used,
                   idx_ignore, idx_equal, time_tsfm, scale_tsfm):
        out = self.predict(inputs, time_tsfm, scale_tsfm)
        all_seqs = self.to_device(all_seqs)
        n, seq_len, _ = all_seqs.shape
        pred = all_seqs.clone()
        if dim_used is not None:
            du = torch.as_tensor(dim_used, device=self.device)
            if out.shape[1] != seq_len:
                pred[:, input_n:, du] = out
            else:
                pred[:, :, du] = out
        elif out.shape[1] != seq_len:
            pred[:, input_n:] = out
        else:
            pred = out
        if idx_ignore is not None:
            ii = torch.as_tensor(idx_ignore, device=self.device)
            ie = torch.as_tensor(idx_equal, device=self.device)
            pred[:, :, ii] = pred[:, :, ie]
        pred_p = pred.reshape(n, seq_len, -1, 3)[:, input_n:]
        targ_p = all_seqs.reshape(n, seq_len, -1, 3)[:, input_n:]
        # per-eval-frame mean joint L2 (summed over the batch via * n)
        ef = torch.as_tensor(eval_frame, device=self.device)
        d = torch.linalg.vector_norm(pred_p[:, ef] - targ_p[:, ef], dim=-1)
        metric = d.mean(dim=(0, 2)) * n
        return metric, pred_p

    def train(self, *args, **kwargs):
        raise NotImplementedError(
            "training is not ported yet: it needs the backward kernels "
            "(ROADMAP Queue 1 item 6, Queue 2 items 5-6)")

    def test(self, test_loader, input_n: int = 10, eval_frame=None,
             dim_used=None, joint_to_ignore=None, joint_equal=None,
             time_tsfm=None, scale_tsfm=None, action=None,
             save_path=None) -> Tuple[float, np.ndarray]:
        """Evaluation sweep; returns (avg metric, per-eval-frame metrics).

        Predictions are scattered into the full-skeleton sequence over
        ``dim_used``, ignored joints are copied from their "equal" sources,
        and MPJPE is computed on the output frames only.
        """
        if eval_frame is None:
            raise ValueError("eval_frame is required")
        eval_frame = np.asarray(eval_frame)
        dim_used = None if dim_used is None else np.asarray(dim_used)
        idx_ignore = idx_equal = None
        if joint_to_ignore is not None and np.asarray(
                joint_to_ignore).dtype != object and np.asarray(
                joint_to_ignore).size and not np.any(
                np.asarray(joint_to_ignore) == None):  # noqa: E711
            ji = np.asarray(joint_to_ignore)
            je = np.asarray(joint_equal)
            idx_ignore = np.concatenate([ji * 3, ji * 3 + 1, ji * 3 + 2])
            idx_equal = np.concatenate([je * 3, je * 3 + 1, je * 3 + 2])

        t_metric = np.zeros(len(eval_frame))
        t_l = L.AccumLoss()
        total_n = 0
        save_results = {"result": [], "target": []} if save_path else None
        self.test_batch_seconds = []
        for inputs, _, _, all_seqs in test_loader:
            t0 = time.perf_counter()
            n = inputs.shape[0]
            metric, pred_p = self._eval_step(
                inputs, all_seqs, input_n, eval_frame, dim_used, idx_ignore,
                idx_equal, time_tsfm, scale_tsfm)
            metric = metric.cpu().numpy()
            self.test_batch_seconds.append(time.perf_counter() - t0)
            t_metric += metric
            for m in metric:
                t_l.update(float(m), n)
            total_n += n
            if save_results is not None:
                save_results["result"].append(pred_p.cpu().numpy())
                seq = np.asarray(all_seqs, np.float32)
                save_results["target"].append(
                    seq.reshape(n, seq.shape[1], -1, 3)[:, input_n:])
        t_metric /= max(total_n, 1)
        if self.logger is not None:
            self.logger.info(
                f"action: {action or 'NA'}|test|loss:{t_l.avg:.2f}")
        if save_results is not None:
            np.savez(str(save_path) + ".npz",
                     target=np.concatenate(save_results["target"]),
                     result=np.concatenate(save_results["result"]))
        return t_l.avg, t_metric
