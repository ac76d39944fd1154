"""Prediction engine: model state, the train step, evaluation, checkpoints.

Counterpart of ``dstdgcn_tpu/engine/engine.py::PredictionEngine``:

* the loss binding ``[type, weight(, out_idx)]`` with ``n_out``;
* the train step (``_build_train_step``): a forward and, with ``inverse``,
  an inverse-sequence forward, both in train mode (BatchNorm statistics
  updated twice, in order), the total halved over the two directions, one
  backward pass, then clipping by global norm (``clip``), L2 weight decay
  added to the gradient and an Adam step (optax's chain
  ``clip_by_global_norm`` → ``add_decayed_weights`` → ``adam``); under a
  bf16 compute dtype the activations inside the model flow in bf16 while
  its output, the losses, the parameters, their gradients and the Adam
  state stay float32, as in the JAX engine;
* StepLR per epoch (:func:`steplr`), written into the param groups;
* ``solver``: the per-group optimizer of :mod:`.solver` (a ``bias`` group
  at ``lr * bias_lr_factor`` with its own weight decay; ``weight_decay``
  defaults to ``learn.weight_decay``) in place of Adam, StepLR driving both
  groups, the clip ahead of it;
* the epoch loop with ``detect_anomaly`` and each epoch's step walls
  (count, median, p95) in the log; ``callbacks`` (``log_dir``, ``name``,
  ``loss_freq``, ``window``): the windowed loss CSV of
  :class:`..utils.callbacks.CallbackLogger`; ``profile`` (a directory) and
  ``profile_steps`` (default 5): a ``torch.profiler`` trace of steps
  ``1 .. profile_steps`` of epoch 0 (:func:`..utils.profiling.trace`);
* spans (:func:`..utils.profiling.span`, recorded only while a profiler
  records, by ``profile`` or any other): ``engine.step`` around each
  step, fetch to loss bookkeeping, holding ``engine.forward`` (inputs to
  the device, both directions' forwards, the losses), ``engine.backward``
  (``zero_grad``, the backward pass, the zero-fill of unreached leaves,
  under a mesh the gradient all-reduce), ``engine.optimizer`` (the clip
  and the optimizer step) and ``engine.sync`` (the synchronize and the
  losses' read-back); in :meth:`test` each batch's
  ``engine.eval_forward``, ``engine.eval_metric`` (scatter, ignored
  joints, MPJPE) and ``engine.readback`` (under a mesh the all-reduce,
  then the metric to the host); the model's DSTD-GC op calls add
  ``dstd.op`` (:class:`..models.layers.DSTDGC`);
* the eval step of ``_build_eval_step`` inside :meth:`test`, through the
  model's forward or, with ``fused_inference``, through the whole-encoder
  kernel (:func:`..models.infer.fused_eval_forward`, weights packed once
  per :meth:`test`); :meth:`predict` always runs the model's forward;
* ``save`` / ``recover`` through :mod:`.checkpoint`; ``recover`` also
  reads the JAX engine's msgpack checkpoints.

Dropout draws from a ``torch.Generator`` on the engine's device seeded
``seed + 1`` (the JAX engine's ``dropout_key``) plus the rank's index on
the data axis, so that ranks draw distinct masks; its stream cannot match
JAX's.  Every dropout module of the model (:class:`..models.layers.Dropout`)
draws from that one generator, in the order the forward reaches them.

``precision: float32`` in the engine block means float32 throughout:
building the engine turns TF32 off for cuBLAS products and cuDNN
convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``, process-wide flags), which cuDNN
otherwise allows for convolutions.

Under a ``mesh`` (:mod:`..parallel.mesh`: each rank holds its data
index's share of every global batch) the engine keeps the JAX engine's
single-device semantics at the same global batch, as GSPMD does there: the
parameters and statistics are broadcast from rank 0 over the mesh after
:meth:`init`; every forward runs under the mesh, so BatchNorm statistics
are the global batch's; each rank's gradients of its local mean loss, and
the losses, are averaged over the data group in one flat all-reduce before
the clip, so every rank steps the same gradient; :meth:`test` sums each
batch's per-frame error and count over the data group.  Under a ``graph``
or ``model`` axis above 1 each rank runs the model on its shard of the
activations (:mod:`..models.layers`) and gets the whole output: each rank
back-propagates ``total / (graph * model)`` (the gathers at the model's
exit sum the identical cotangents of the ranks that share a data index),
the flat all-reduce runs over all the mesh's ranks and divides by
``data``, and each rank's block of the running BatchNorm statistics is
gathered after the step (:meth:`_gather_statistics`), so every rank holds
the whole, equal state.  Rank 0 alone writes (checkpoints, callbacks, the
profile trace), the others waiting at a barrier after a checkpoint; every
rank reads in :meth:`recover`.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data import transforms as tfm
from ..models import infer
from ..models.layers import Dropout, JointBatchNorm
from ..parallel.mesh import activation_sharding_context
from ..utils import profiling
from ..utils.bridge import load_flax_variables
from ..utils.device import resolve_device
from . import losses as L
from .checkpoint import jax_optimizer_state, load_checkpoint, save_checkpoint
from .solver import make_optimizer

__all__ = ["PredictionEngine", "steplr"]


def steplr(lr0: float, gamma: float, step_size: int) -> Callable[[int], float]:
    """torch StepLR: lr(epoch) = lr0 * gamma ** (epoch // step_size)."""

    def schedule(epoch: int) -> float:
        return lr0 * (gamma ** (epoch // step_size))

    return schedule


def _walls_summary(walls: List[float]) -> str:
    """Count, median and 95th percentile of step walls (seconds), in ms."""
    if not walls:
        return "no timed steps"
    med, p95 = 1e3 * np.percentile(np.asarray(walls), [50, 95])
    return f"{len(walls)} steps | median {med:.2f} ms | p95 {p95:.2f} ms"


class PredictionEngine:
    """Owns the model, optimizer and dropout generator on one device.

    ``config`` is the ``engine`` block of the experiment config:
    learn{opt, lr, weight_decay, gamma, step_size}, loss{name: [type,
    weight(, out_idx)]}, n_out, transform, inverse, max_iter, and optionally
    clip, detect_anomaly, solver, callbacks, profile, profile_steps and
    precision.
    ``prng_impl`` names a JAX PRNG and has no meaning here; it is accepted
    and ignored.  ``mesh`` (a :class:`..parallel.mesh.Mesh`, or None for
    one process) makes the engine data parallel over the mesh's data group
    and splits the model's activations over its graph and model axes.
    """

    def __init__(self, config: Dict[str, Any], model: torch.nn.Module,
                 logger=None, device: str | torch.device = "cuda",
                 bone_incidence=None, mesh=None):
        self.mesh = mesh
        #: whether this process writes the run's files (rank 0, or the only
        #: process)
        self.writes = not dist.is_initialized() or dist.get_rank() == 0
        self.config = config
        self.logger = logger
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.transform_fn, self.inverse_fn = tfm.get_transform(
            config.get("transform", "tsc"))

        reg = dict(L.registry(bone_incidence), **L.FORECAST)
        self.n_out = int(config.get("n_out", 1))
        self.loss_funcs: Dict[str, Tuple[Callable, float, int]] = {}
        for name, spec in config["loss"].items():
            out_idx = int(spec[2]) if len(spec) > 2 else 0
            if out_idx >= self.n_out:
                raise ValueError(
                    f"loss {name!r} binds output {out_idx} but n_out="
                    f"{self.n_out}")
            self.loss_funcs[name] = (reg[spec[0]], float(spec[1]), out_idx)

        if config.get("precision") == "float32":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        learn = config["learn"]
        self.lr_schedule = steplr(float(learn["lr"]), float(learn["gamma"]),
                                  int(learn["step_size"]))
        self.lr = float(learn["lr"])
        self.weight_decay = float(learn.get("weight_decay", 0.0))
        self.solver = dict(config.get("solver") or {})
        if self.solver:
            self.solver.setdefault("weight_decay", self.weight_decay)
        self.clip = float(config.get("clip", -1))
        self.inverse_training = bool(config.get("inverse", False))
        self.fused_inference = bool(config.get("fused_inference", False))
        self.optimizer: torch.optim.Optimizer | None = None
        self.generator: torch.Generator | None = None
        self._callbacks = None
        self._last_losses: Dict[str, float] = {}
        self.best_err = float("inf")
        #: host seconds of each batch of the last :meth:`test`, device work
        #: included (the metric is read back every batch)
        self.test_batch_seconds: List[float] = []
        #: host seconds of each :meth:`train` step since :meth:`init`, each
        #: ending in a device synchronize
        self.train_step_seconds: List[float] = []
        #: host seconds of fetching each :meth:`train` batch from the
        #: loader since :meth:`init`
        self.train_fetch_seconds: List[float] = []

    # -- state ------------------------------------------------------------

    def init(self, seed: int = 777) -> torch.nn.Module:
        """Draw the model's parameters from ``seed`` (under a mesh, rank
        0's, broadcast to every rank of the mesh), seed the dropout
        generator with ``seed + 1`` plus the rank's data index (equal on the
        ranks of one data index), build the optimizer (Adam, or the
        ``solver`` block's); eval mode."""
        gen = torch.Generator().manual_seed(seed)
        self.model.cpu().reset_parameters(gen)
        self.model.to(self.device).eval()
        rank = 0
        if self.mesh is not None:
            rank = self.mesh.index("data")
            with torch.no_grad():
                for t in list(self.model.parameters()) + list(
                        self.model.buffers()):
                    dist.broadcast(t, src=0, group=self.mesh.all_group)
        self.generator = torch.Generator(self.device).manual_seed(
            seed + 1 + rank)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.generator
        if self.solver:
            self.optimizer = make_optimizer(
                dict(self.solver, base_lr=self.lr),
                self.model.named_parameters())
        else:
            self.optimizer = torch.optim.Adam(
                self.model.parameters(), lr=self.lr,
                weight_decay=self.weight_decay)
        self.train_step_seconds = []
        self.train_fetch_seconds = []
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
        """``a`` (an array, or a tensor on any device) as float32 on the
        engine's device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(
            self.device)

    # -- serving ----------------------------------------------------------

    @torch.inference_mode()
    def predict(self, inputs, time_tsfm=None, scale_tsfm=None) \
            -> torch.Tensor:
        """Model output for flat input sequences ``(N, T, S)`` in the flat
        exchange layout, on the engine's device (the model's forward)."""
        self.model.eval()
        with activation_sharding_context(self.mesh):
            return self._serve(inputs, self.model, time_tsfm, scale_tsfm)

    def _serve(self, inputs, forward, time_tsfm, scale_tsfm):
        x = self.transform(self.to_device(inputs))
        out = forward(x)
        if isinstance(out, (list, tuple)):   # multi-output: use the last
            out = out[-1]
        return self._inverse_out(out, time_tsfm, scale_tsfm)

    @torch.inference_mode()
    def _eval_forward(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """The eval step's forward: the model's, or with
        ``engine.fused_inference`` the fused path, its weights derived once
        for the sweep (eval weights do not change within one) and its
        compute dtype resolved per batch as the model resolves it ("auto"
        at the model's batch hint)."""
        model = self.model.eval()
        if not self.fused_inference:
            return model
        weights = infer.fused_weights(model)

        def forward(x: torch.Tensor) -> torch.Tensor:
            cd = model.resolve_knobs(x.shape[0])["compute_dtype"]
            return infer.fused_eval_forward(
                model, x, dtype=None if cd is None else getattr(torch, cd),
                weights=weights)

        return forward

    @torch.inference_mode()
    def _eval_step(self, forward, inputs, all_seqs, input_n, eval_frame,
                   dim_used, idx_ignore, idx_equal, time_tsfm, scale_tsfm):
        with profiling.span("engine.eval_forward"):
            out = self._serve(inputs, forward, time_tsfm, scale_tsfm)
        with profiling.span("engine.eval_metric"):
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
            d = torch.linalg.vector_norm(pred_p[:, ef] - targ_p[:, ef],
                                         dim=-1)
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
        with profiling.span("engine.forward"):
            self.model.train()
            inputs, inputs_inv, targets = (self.to_device(a) for a in
                                           (inputs, inputs_inv, targets))
            wvec = None if weights is None else self.to_device(weights)
            with activation_sharding_context(self.mesh):
                losses = self._one_pass(inputs, targets, time_tsfm,
                                        scale_tsfm, wvec)
                total = functools.reduce(torch.add, losses.values())
                if self.inverse_training:
                    losses_inv = self._one_pass(inputs_inv, targets.flip(1),
                                                time_tsfm, scale_tsfm, wvec)
                    total = (total + functools.reduce(
                        torch.add, losses_inv.values())) / 2
        with profiling.span("engine.backward"):
            with activation_sharding_context(self.mesh):
                self.model.zero_grad(set_to_none=True)
                split = self._split()
                (total / split if split > 1 else total).backward()
            for p in self.model.parameters():   # optax updates every one
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            out = {name: val.detach() for name, val in losses.items()}
            out["total"] = total.detach()
            if self.mesh is not None:
                self._average_over_data(out)
        return out

    def _split(self) -> int:
        """``graph * model``: the ranks that share a data index."""
        return 1 if self.mesh is None else self.mesh.size // \
            self.mesh.shape["data"]

    def _average_over_data(self, losses: Dict[str, torch.Tensor]) -> None:
        """Average every gradient and ``losses`` (in place) over the data
        group: one flat all-reduce of the gradients and losses, divided by
        the group's size.  Under a graph or model axis the all-reduce runs
        over every rank of the mesh: each rank holds its share of the
        gradient of ``total / (graph * model)`` and the losses of its data
        index, which enter divided by ``graph * model``; then the running
        statistics are gathered (:meth:`_gather_statistics`)."""
        split = self._split()
        grads = [p.grad for p in self.model.parameters()]
        vals = [v.reshape(1).to(grads[0].dtype) for v in losses.values()]
        if split > 1:
            vals = [v / split for v in vals]
        flat = torch.cat([g.reshape(-1) for g in grads] + vals)
        dist.all_reduce(flat, group=self.mesh.group("data") if split == 1
                        else self.mesh.all_group)
        flat /= self.mesh.shape["data"]
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()
        for name, v in losses.items():
            losses[name] = flat[i].to(v.dtype)
            i += 1
        if split > 1:
            self._gather_statistics()

    @torch.no_grad()
    def _gather_statistics(self) -> None:
        """Make every JointBatchNorm's running statistics whole on every
        rank: a rank's train-mode forward updated its (joint, channel)
        block alone (:class:`..models.layers.JointBatchNorm`).  One
        all-gather over the mesh's ranks of each rank's blocks, every
        block's rows padded to the graph split's block size."""
        mesh = self.mesh
        bns = [m for m in self.model.modules()
               if isinstance(m, JointBatchNorm)]
        g = mesh.shape.get("graph", 1)

        def block(bn, rank):
            c = mesh.coords_of(rank)
            return (mesh.joints(bn.mean.shape[0], c["graph"]),
                    mesh.channels(bn.mean.shape[1], c["model"]))

        pieces = []
        me = dist.get_rank(mesh.all_group)
        for bn in bns:
            rows, cols = block(bn, me)
            piece = torch.stack([bn.mean[rows, cols], bn.var[rows, cols]])
            pad = -(-bn.mean.shape[0] // g) - piece.shape[1]
            pieces.append(torch.cat([piece, piece.new_zeros(
                (2, pad, piece.shape[2]))], 1).reshape(-1))
        flat = torch.cat(pieces)
        every = flat.new_empty(mesh.size * flat.numel())
        dist.all_gather_into_tensor(every, flat, group=mesh.all_group)
        every = every.view(mesh.size, -1)
        for rank in range(mesh.size):
            i = 0
            for bn, piece in zip(bns, pieces):
                rows, cols = block(bn, rank)
                got = every[rank, i:i + piece.numel()].view(
                    2, -1, cols.stop - cols.start)
                n = rows.stop - rows.start
                bn.mean[rows, cols] = got[0, :n]
                bn.var[rows, cols] = got[1, :n]
                i += piece.numel()

    def train_step(self, inputs, inputs_inv, targets, time_tsfm=None,
                   scale_tsfm=None, weights=None) -> Dict[str, torch.Tensor]:
        """One optimizer step on one batch: :meth:`compute_gradients`, the
        clip by global norm, then Adam with L2 weight decay added to the
        gradient (or the ``solver`` block's optimizer); returns the losses
        of :meth:`compute_gradients`."""
        if self.optimizer is None:
            raise RuntimeError("call init() first")
        losses = self.compute_gradients(inputs, inputs_inv, targets,
                                        time_tsfm, scale_tsfm, weights)
        with profiling.span("engine.optimizer"):
            if self.clip > 0:
                self._clip_gradients([p.grad
                                      for p in self.model.parameters()])
            self.optimizer.step()
        return losses

    def set_epoch_lr(self, epoch: int) -> float:
        """Set the StepLR learning rate of ``epoch`` into the optimizer
        (each group's ``lr_factor`` times it under ``solver``)."""
        if self.optimizer is None:
            raise RuntimeError("call init() first")
        self.lr = self.lr_schedule(epoch)
        self._apply_lr()
        return self.lr

    def _apply_lr(self) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = self.lr * group.get("lr_factor", 1.0)

    def train(self, train_loader, epoch: int, time_tsfm=None,
              scale_tsfm=None, weights=None, max_iter: int = -1) -> float:
        """One training epoch; returns the summed average losses."""
        self.set_epoch_lr(epoch)
        # the windowed per-loss CSV of utils.callbacks (engine.callbacks)
        cb_cfg = self.config.get("callbacks") if self.writes else None
        if cb_cfg and self._callbacks is None:
            from ..utils.callbacks import CallbackLogger
            self._callbacks = CallbackLogger(
                str(cb_cfg.get("log_dir", ".")), epoch=epoch,
                name=str(cb_cfg.get("name", "train")))
            self._callbacks.add_loss_log(
                lambda: self._last_losses, int(cb_cfg.get("loss_freq", 1)),
                int(cb_cfg.get("window", 100)))
        t_l = {name: L.AccumLoss() for name in self.loss_funcs}
        num_iter = (len(train_loader) if max_iter == -1
                    else min(len(train_loader), max_iter))
        first = len(self.train_step_seconds)
        # a profiler trace of steps 1 .. profile_steps of the first epoch
        # (engine.profile: the directory)
        profile_dir = (self.config.get("profile")
                       if epoch == 0 and self.writes else None)
        profile_steps = int(self.config.get("profile_steps", 5))
        # fail fast on non-finite losses (engine.detect_anomaly)
        detect_anomaly = bool(self.config.get("detect_anomaly", False))
        desc = ""
        it = iter(train_loader)
        with contextlib.ExitStack() as tracing:   # closed on a raise too
            for i in range(num_iter):
                if profile_dir and i == 1:
                    tracing.enter_context(profiling.trace(profile_dir))
                elif i == 1 + profile_steps:
                    tracing.close()
                with profiling.span("engine.step"):
                    t0 = time.perf_counter()
                    try:
                        inputs, inputs_inv, targets, _ = next(it)
                    except StopIteration:
                        break
                    t1 = time.perf_counter()
                    self.train_fetch_seconds.append(t1 - t0)
                    n = inputs.shape[0] * self._data_size()
                    losses = self.train_step(inputs, inputs_inv, targets,
                                             time_tsfm, scale_tsfm, weights)
                    with profiling.span("engine.sync"):
                        if self.device.type == "cuda":
                            torch.cuda.synchronize(self.device)
                        self.train_step_seconds.append(
                            time.perf_counter() - t1)
                        vals = dict(zip(losses, torch.stack(
                            list(losses.values())).tolist()))
                    if detect_anomaly:
                        bad = [name for name, val in vals.items()
                               if not np.isfinite(val)]
                        if bad:
                            raise FloatingPointError(
                                f"non-finite loss {bad} at epoch {epoch + 1} "
                                f"step {i + 1} (lr={self.lr:.2e}); enable "
                                f"smaller lr or clipping")
                    for name, val in vals.items():
                        if name == "total":   # the objective, not a loss
                            continue
                        t_l[name].update(val * n, n)
                    if self._callbacks is not None:
                        self._last_losses = vals
                        self._callbacks.step()
                    desc = (f"epoch: {epoch + 1}|[{i + 1}/{num_iter}]|train|"
                            + "".join("{}:{:.2f}|".format(name,
                                                          t_l[name].avg)
                                      for name in t_l))
        if self._callbacks is not None:
            self._callbacks.end_epoch()
        if self.logger is not None:
            self.logger.info(desc)
            walls = self.train_step_seconds[first:]
            self.logger.info(f"epoch {epoch + 1} step timing: "
                             f"{_walls_summary(walls)}")
        return sum(acc.avg for acc in t_l.values())

    def test(self, test_loader, input_n: int = 10, eval_frame=None,
             dim_used=None, joint_to_ignore=None, joint_equal=None,
             time_tsfm=None, scale_tsfm=None, action=None,
             save_path=None) -> Tuple[float, np.ndarray]:
        """Evaluation sweep; returns (avg metric, per-eval-frame metrics).

        Predictions are scattered into the full-skeleton sequence over
        ``dim_used``, ignored joints are copied from their "equal" sources,
        and MPJPE is computed on the output frames only.  Under a mesh each
        batch's error sums and count are summed over the data group, and
        the saved results are the global batches' (rank 0 writes them).
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
        with activation_sharding_context(self.mesh):
            forward = self._eval_forward()
        for inputs, _, _, all_seqs in test_loader:
            t0 = time.perf_counter()
            n = inputs.shape[0]
            with activation_sharding_context(self.mesh):
                metric, pred_p = self._eval_step(
                    forward, inputs, all_seqs, input_n, eval_frame, dim_used,
                    idx_ignore, idx_equal, time_tsfm, scale_tsfm)
            with profiling.span("engine.readback"):
                if self.mesh is not None:
                    summed = torch.cat([metric, metric.new_tensor([n])])
                    dist.all_reduce(summed, group=self.mesh.group("data"))
                    metric, n = summed[:-1], int(summed[-1])
                metric = metric.cpu().numpy()
            self.test_batch_seconds.append(time.perf_counter() - t0)
            t_metric += metric
            for m in metric:
                t_l.update(float(m), n)
            total_n += n
            if save_results is not None:
                seq = np.asarray(all_seqs, np.float32)
                save_results["result"].append(
                    self._gather_rows(pred_p.cpu().numpy()))
                save_results["target"].append(self._gather_rows(
                    seq.reshape(seq.shape[0], seq.shape[1], -1,
                                3)[:, input_n:]))
        t_metric /= max(total_n, 1)
        if self.logger is not None:
            self.logger.info(
                f"action: {action or 'NA'}|test|loss:{t_l.avg:.2f}")
        if save_results is not None and self.writes:
            np.savez(str(save_path) + ".npz",
                     target=np.concatenate(save_results["target"]),
                     result=np.concatenate(save_results["result"]))
        return t_l.avg, t_metric

    def _data_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape["data"]

    def _gather_rows(self, rows: np.ndarray) -> np.ndarray:
        """The global batch of this rank's ``rows`` under a mesh: the data
        group's shares interleaved back into the loader's order (its split
        is ``idx[rank::count]``); ``rows`` itself without one."""
        if self.mesh is None:
            return rows
        shares = [None] * self._data_size()
        dist.all_gather_object(shares, rows, group=self.mesh.group("data"))
        out = np.empty((sum(len(a) for a in shares),) + rows.shape[1:],
                       rows.dtype)
        for r, a in enumerate(shares):
            out[r::len(shares)] = a
        return out

    # -- checkpointing ----------------------------------------------------

    def save(self, checkpoint_dir: str, err: float, epoch: int,
             is_best: bool = False) -> None:
        """Write ``last.ckpt`` (and ``best.ckpt``); under a mesh rank 0
        writes and every rank waits at a barrier until it has."""
        if self.writes:
            os.makedirs(checkpoint_dir, exist_ok=True)
            payload = dict(lr=self.lr, err=float(err), epoch=int(epoch))
            names = ["last.ckpt"] + (["best.ckpt"] if is_best else [])
            for name in names:
                save_checkpoint(os.path.join(checkpoint_dir, name),
                                self.model, self.optimizer, self.generator,
                                payload)
        if self.mesh is not None:
            dist.barrier(group=self.mesh.all_group)

    def recover(self, checkpoint_path: str,
                model_only: bool = False) -> Tuple[int, float]:
        """Load a checkpoint of :meth:`save`: the model (parameters and
        BatchNorm statistics) and, unless ``model_only``, the optimizer,
        the dropout generator and the learning rate.  A checkpoint of the
        JAX engine loads its ``params`` and ``batch_stats`` through the
        weight bridge and, unless ``model_only``, its optimizer state
        (:func:`.checkpoint.jax_optimizer_state`) and the payload's
        learning rate; the dropout generator stays the engine's own."""
        ckpt = load_checkpoint(checkpoint_path)
        payload = ckpt["payload"]
        jax_state = ckpt.get("jax_state")
        if jax_state is not None:
            load_flax_variables(self.model, {
                "params": jax_state["params"],
                "batch_stats": jax_state.get("batch_stats") or {}})
            if not model_only:
                self.optimizer.load_state_dict(jax_optimizer_state(
                    self.optimizer, self.model, jax_state["opt_state"]))
                self.lr = payload["lr"]
                self._apply_lr()
        else:
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
