"""Per-parameter-group optimizer.

Counterpart of ``dstdgcn_tpu/engine/solver.py::make_optimizer``: a
parameter whose last name component contains ``"bias"`` or equals ``"b"``
(:func:`is_bias`) goes to the ``bias`` group, which gets ``lr *
bias_lr_factor`` and ``weight_decay_bias``; every other parameter goes to
the ``base`` group, with ``lr`` and ``weight_decay``.  The port names its
parameters after the flax tree, so the groups are the JAX package's labels.

The update rules are optax's.  Weight decay is L2 added to the gradient
before the optimizer (``optax.add_decayed_weights``), for ``adamw`` too:

* ``adam`` and ``adamw``: ``torch.optim.Adam`` with ``weight_decay``
  (optax's ``adam`` defaults: betas 0.9, 0.999, eps 1e-8 outside the
  square root);
* ``sgd``: ``torch.optim.SGD``, dampening 0, the momentum trace on the raw
  gradient (optax's ``trace`` before ``scale_by_learning_rate``);
* ``rmsprop``: :class:`RMSprop`, optax's ``scale_by_rms`` (decay 0.9, eps
  inside the square root), then the learning rate, then the momentum
  trace; ``torch.optim.RMSprop`` (alpha 0.99, eps outside, the trace
  before the learning rate) differs.

Each group carries its ``label`` and its ``lr_factor`` (1 for ``base``),
so a schedule sets ``group["lr"] = lr * group["lr_factor"]`` as the JAX
engine's one injected learning rate drives both groups.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Tuple

import torch

__all__ = ["make_optimizer", "is_bias", "RMSprop", "OPTIMIZERS"]

#: optimizer names of the ``engine.solver`` block
OPTIMIZERS = ("adam", "adamw", "sgd", "rmsprop")


def is_bias(name: str) -> bool:
    """The JAX package's bias predicate on a dotted parameter name."""
    leaf = name.rsplit(".", 1)[-1]
    return "bias" in leaf or leaf == "b"


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop``: ``nu = decay nu + (1 - decay) g^2``, the update
    ``u = -lr g / sqrt(nu + eps)``; with ``momentum`` the step is the trace
    ``t = u + momentum t``.  State per parameter: ``square_avg`` (optax's
    ``nu``) and, with momentum, ``momentum_buffer`` (optax's ``trace``, in
    units of the update)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8, momentum: float = 0.0,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps,
                                      momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            decay, eps = group["decay"], group["eps"]
            momentum, wd = group["momentum"], group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g + wd * p
                state = self.state[p]
                nu = state.setdefault("square_avg", torch.zeros_like(p))
                nu.copy_((1 - decay) * (g * g) + decay * nu)
                u = (g * torch.rsqrt(nu + eps)) * -group["lr"]
                if momentum:
                    trace = state.setdefault("momentum_buffer",
                                             torch.zeros_like(p))
                    trace.copy_(u + momentum * trace)
                    u = trace
                p.add_(u)
        return loss


def _groups(named_params: Iterable[Tuple[str, torch.nn.Parameter]],
            lr: float, factor: float, wd: float, wd_bias: float) \
        -> List[Dict[str, Any]]:
    params = {"base": [], "bias": []}
    for name, p in named_params:
        params["bias" if is_bias(name) else "base"].append(p)
    groups = [dict(params=params["base"], lr=lr, weight_decay=wd,
                   lr_factor=1.0, label="base"),
              dict(params=params["bias"], lr=lr * factor,
                   weight_decay=wd_bias, lr_factor=factor, label="bias")]
    return [g for g in groups if g["params"]]


def make_optimizer(cfg: Dict[str, Any],
                   named_params: Iterable[Tuple[str, torch.nn.Parameter]]) \
        -> torch.optim.Optimizer:
    """An optimizer with a ``base`` and a ``bias`` parameter group.

    ``cfg`` keys (the JAX package's ``engine.solver`` block):
    ``optimizer_name``, ``base_lr``, ``bias_lr_factor``, ``weight_decay``,
    ``weight_decay_bias`` (default: ``weight_decay``), ``momentum`` (sgd and
    rmsprop; adam ignores it).  ``named_params`` as
    ``model.named_parameters()`` gives them.
    """
    name = str(cfg.get("optimizer_name", "adam")).lower()
    if name not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {name!r}")
    lr = float(cfg.get("base_lr", 1e-3))
    wd = float(cfg.get("weight_decay", 0.0))
    groups = _groups(named_params, lr, float(cfg.get("bias_lr_factor", 1.0)),
                     wd, float(cfg.get("weight_decay_bias", wd)))
    momentum = float(cfg.get("momentum", 0.0))
    if name in ("adam", "adamw"):
        return torch.optim.Adam(groups, lr=lr)
    if name == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=momentum,
                               dampening=0.0)
    return RMSprop(groups, lr=lr, momentum=momentum)
