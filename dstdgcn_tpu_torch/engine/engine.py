"""Prediction engine: model state, the train step, evaluation, checkpoints.

Counterpart of ``dstdgcn_tpu/engine/engine.py::PredictionEngine``:

* the loss binding ``[type, weight(, out_idx)]`` with ``n_out``;
* the train step (``_build_train_step``): a forward and, with ``inverse``,
  an inverse-sequence forward, both in train mode (BatchNorm statistics
  updated twice, in order), the total halved over the two directions, one
  backward pass, then clipping by global norm (``clip``), L2 weight decay
  added to the gradient and an Adam step (optax's chain
  ``clip_by_global_norm`` → ``add_decayed_weights`` → ``adam``);
* StepLR per epoch (:func:`steplr`), written into the param groups;
* the epoch loop with ``detect_anomaly`` and the step-timer summary;
* the eval step of ``_build_eval_step`` inside :meth:`test`;
* ``save`` / ``recover`` through :mod:`.checkpoint`.

Dropout draws from a ``torch.Generator`` on the engine's device seeded
``seed + 1`` (the JAX engine's ``dropout_key``); its stream cannot match
JAX's.  Config keys of the JAX engine that are not ported raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import functools
import os
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from ..data import transforms as tfm
from ..utils.device import resolve_device
from ..utils.profiling import StepTimer
from . import losses as L
from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["PredictionEngine", "steplr"]

#: engine keys of the JAX package that the port does not have yet
_UNPORTED = {
    "fused_inference": "the whole-encoder kernel, ROADMAP Queue 2 item 4",
    "solver": "engine/solver.py, ROADMAP Queue 1 item 6",
    "callbacks": "utils/callbacks.py, ROADMAP Queue 1 item 11",
    "profile": "the profiler trace hook, ROADMAP Queue 1 item 11",
}


def steplr(lr0: float, gamma: float, step_size: int) -> Callable[[int], float]:
    """torch StepLR: lr(epoch) = lr0 * gamma ** (epoch // step_size)."""

    def schedule(epoch: int) -> float:
        return lr0 * (gamma ** (epoch // step_size))

    return schedule


class PredictionEngine:
    """Owns the model, optimizer and dropout generator on one device.

    ``config`` is the ``engine`` block of the experiment config:
    learn{opt, lr, weight_decay, gamma, step_size}, loss{name: [type,
    weight(, out_idx)]}, n_out, transform, inverse, max_iter, and optionally
    clip and detect_anomaly.  ``prng_impl`` names a JAX PRNG and has no
    meaning here; it is accepted and ignored.
    """

    def __init__(self, config: Dict[str, Any], model: torch.nn.Module,
                 logger=None, device: str | torch.device = "cuda",
                 bone_incidence=None):
        for key, where in _UNPORTED.items():
            if config.get(key):
                raise NotImplementedError(
                    f"engine.{key} is not ported yet ({where})")
        self.config = config
        self.logger = logger
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.transform_fn, self.inverse_fn = tfm.get_transform(
            config.get("transform", "tsc"))

        reg = L.registry(bone_incidence)
        self.n_out = int(config.get("n_out", 1))
        self.loss_funcs: Dict[str, Tuple[Callable, float, int]] = {}
        for name, spec in config["loss"].items():
            out_idx = int(spec[2]) if len(spec) > 2 else 0
            if out_idx >= self.n_out:
                raise ValueError(
                    f"loss {name!r} binds output {out_idx} but n_out="
                    f"{self.n_out}")
            self.loss_funcs[name] = (reg[spec[0]], float(spec[1]), out_idx)

        learn = config["learn"]
        self.lr_schedule = steplr(float(learn["lr"]), float(learn["gamma"]),
                                  int(learn["step_size"]))
        self.lr = float(learn["lr"])
        self.weight_decay = float(learn.get("weight_decay", 0.0))
        self.clip = float(config.get("clip", -1))
        self.inverse_training = bool(config.get("inverse", False))
        self.optimizer: torch.optim.Optimizer | None = None
        self.generator: torch.Generator | None = None
        self.best_err = float("inf")
        #: host seconds of each batch of the last :meth:`test`, device work
        #: included (the metric is read back every batch)
        self.test_batch_seconds: List[float] = []
        #: host seconds of each :meth:`train` step since :meth:`init`, each
        #: ending in a device synchronize
        self.train_step_seconds: List[float] = []

    # -- state ------------------------------------------------------------

    def init(self, seed: int = 777) -> torch.nn.Module:
        """Draw the model's parameters from ``seed``, seed the dropout
        generator with ``seed + 1``, build the Adam state; eval mode."""
        gen = torch.Generator().manual_seed(seed)
        self.model.cpu().reset_parameters(gen)
        self.model.to(self.device).eval()
        self.generator = torch.Generator(self.device).manual_seed(seed + 1)
        dropout = getattr(self.model, "do_in", None)
        if dropout is not None:
            dropout.generator = self.generator
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                          weight_decay=self.weight_decay)
        self.train_step_seconds = []
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

    # -- training ---------------------------------------------------------

    def _inverse_out(self, out, time_tsfm, scale_tsfm):
        out = self.inverse(out)
        if scale_tsfm is not None:
            out = scale_tsfm.inverse(out)
        if time_tsfm is not None:
            out = time_tsfm.inverse(out)
        return out

    def _one_pass(self, inputs, targets, time_tsfm, scale_tsfm, wvec):
        """Train-mode forward and the bound losses of one direction."""
        x = inputs
        if time_tsfm is not None:
            x = time_tsfm.transform(x)
        out = self.model(self.transform(x))
        outs = ([self._inverse_out(o, time_tsfm, scale_tsfm) for o in out]
                if isinstance(out, (list, tuple))
                else [self._inverse_out(out, time_tsfm, scale_tsfm)])

        def per_output_target(o):
            t_out, t_tgt = o.shape[1], targets.shape[1]
            return targets[:, -t_out:] if t_out != t_tgt else targets

        return {name: w * fn(outs[i], per_output_target(outs[i]), wvec)
                for name, (fn, w, i) in self.loss_funcs.items()}

    def _clip_gradients(self, grads: List[torch.Tensor]) -> None:
        """optax.clip_by_global_norm: unchanged below the limit, else each
        gradient becomes ``g / norm * clip``."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads))
        keep = norm < self.clip
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.clip))

    def compute_gradients(self, inputs, inputs_inv, targets, time_tsfm=None,
                          scale_tsfm=None, weights=None):
        """Train-mode loss of one batch and its gradient in each
        parameter's ``.grad`` (zeros for a parameter the loss does not
        reach); returns the weighted losses of the forward direction and
        ``total``, the optimized objective (the halved two-direction total
        under inverse training)."""
        self.model.train()
        inputs, inputs_inv, targets = (self.to_device(a) for a in
                                       (inputs, inputs_inv, targets))
        wvec = None if weights is None else self.to_device(weights)
        losses = self._one_pass(inputs, targets, time_tsfm, scale_tsfm, wvec)
        total = functools.reduce(torch.add, losses.values())
        if self.inverse_training:
            losses_inv = self._one_pass(inputs_inv, targets.flip(1),
                                        time_tsfm, scale_tsfm, wvec)
            total = (total + functools.reduce(torch.add,
                                              losses_inv.values())) / 2
        self.model.zero_grad(set_to_none=True)
        total.backward()
        for p in self.model.parameters():   # optax updates every parameter
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        out = {name: val.detach() for name, val in losses.items()}
        out["total"] = total.detach()
        return out

    def train_step(self, inputs, inputs_inv, targets, time_tsfm=None,
                   scale_tsfm=None, weights=None) -> Dict[str, torch.Tensor]:
        """One optimizer step on one batch: :meth:`compute_gradients`, the
        clip by global norm, then Adam (with L2 weight decay added to the
        gradient); returns the losses of :meth:`compute_gradients`."""
        if self.optimizer is None:
            raise RuntimeError("call init() first")
        losses = self.compute_gradients(inputs, inputs_inv, targets,
                                        time_tsfm, scale_tsfm, weights)
        if self.clip > 0:
            self._clip_gradients([p.grad for p in self.model.parameters()])
        self.optimizer.step()
        return losses

    def set_epoch_lr(self, epoch: int) -> float:
        """Set the StepLR learning rate of ``epoch`` into the optimizer."""
        if self.optimizer is None:
            raise RuntimeError("call init() first")
        self.lr = self.lr_schedule(epoch)
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr
        return self.lr

    def train(self, train_loader, epoch: int, time_tsfm=None,
              scale_tsfm=None, weights=None, max_iter: int = -1) -> float:
        """One training epoch; returns the summed average losses."""
        self.set_epoch_lr(epoch)
        t_l = {name: L.AccumLoss() for name in self.loss_funcs}
        num_iter = (len(train_loader) if max_iter == -1
                    else min(len(train_loader), max_iter))
        timer = StepTimer(skip_first=1)
        # fail fast on non-finite losses (engine.detect_anomaly)
        detect_anomaly = bool(self.config.get("detect_anomaly", False))
        desc = ""
        it = iter(train_loader)
        for i in range(num_iter):
            try:
                inputs, inputs_inv, targets, _ = next(it)
            except StopIteration:
                break
            n = inputs.shape[0]
            timer.tic()
            losses = self.train_step(inputs, inputs_inv, targets, time_tsfm,
                                     scale_tsfm, weights)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.train_step_seconds.append(timer.toc())
            vals = dict(zip(losses, torch.stack(list(losses.values()))
                            .tolist()))
            if detect_anomaly:
                bad = [name for name, val in vals.items()
                       if not np.isfinite(val)]
                if bad:
                    raise FloatingPointError(
                        f"non-finite loss {bad} at epoch {epoch + 1} "
                        f"step {i + 1} (lr={self.lr:.2e}); enable "
                        f"smaller lr or clipping")
            for name, val in vals.items():
                if name == "total":   # reported objective, not a loss term
                    continue
                t_l[name].update(val * n, n)
            desc = f"epoch: {epoch + 1}|[{i + 1}/{num_iter}]|train|" + "".join(
                "{}:{:.2f}|".format(name, t_l[name].avg) for name in t_l)
        if self.logger is not None:
            self.logger.info(desc)
            self.logger.info(f"epoch {epoch + 1} step timing: "
                             f"{timer.summary()}")
        return sum(acc.avg for acc in t_l.values())

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

    # -- checkpointing ----------------------------------------------------

    def save(self, checkpoint_dir: str, err: float, epoch: int,
             is_best: bool = False) -> None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        payload = dict(lr=self.lr, err=float(err), epoch=int(epoch))
        names = ["last.ckpt"] + (["best.ckpt"] if is_best else [])
        for name in names:
            save_checkpoint(os.path.join(checkpoint_dir, name), self.model,
                            self.optimizer, self.generator, payload)

    def recover(self, checkpoint_path: str,
                model_only: bool = False) -> Tuple[int, float]:
        """Load a checkpoint of :meth:`save`: the model (parameters and
        BatchNorm statistics) and, unless ``model_only``, the optimizer,
        the dropout generator and the learning rate."""
        ckpt = load_checkpoint(checkpoint_path)
        payload = ckpt["payload"]
        self.model.load_state_dict(ckpt["model"])
        if not model_only:
            self.optimizer.load_state_dict(ckpt["optimizer"])
            self.generator.set_state(ckpt["generator"])
            self.lr = payload["lr"]
        if self.logger is not None:
            self.logger.info(
                "load from lr {}, curr_avg {} from {}.".format(
                    payload["lr"], payload["err"], checkpoint_path))
        return payload["epoch"], payload["err"]
