"""Loss library and running averages.

Counterpart of ``dstdgcn_tpu/engine/losses.py``.  Every loss takes flat
sequences ``(N, T, V*3)`` (the engine's exchange layout) and an optional
per-joint weight vector, and returns a scalar.  Registry keys: jl2, bl2,
tl2, cl1, cl2, gm2, with the JAX package's semantics kept exactly: the
weighted MPJPE weights the coordinates once, ``cl2`` is a mean absolute
error (the reference computes ``mean(sqrt(d**2))``), ``gm2`` takes its
target Gram from the target, and ``bl2`` uses the active layout's bone
incidence (``graphs/skeleton.py::bone_incidence``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["mpjpe_error", "mae_error", "mse_error", "transition_error",
           "gram_matrix_loss", "make_bone_error", "registry", "AccumLoss"]


def _to_joints(x: torch.Tensor, w: Optional[torch.Tensor]) -> torch.Tensor:
    n, t, vc = x.shape
    x = x.reshape(n, t, vc // 3, 3)
    if w is not None:
        x = x * w[None, None, :, None]
    return x


def mpjpe_error(pred, target, weights=None) -> torch.Tensor:
    """Mean per-joint position error (L2 over xyz), ``jl2``."""
    p, t = _to_joints(pred, weights), _to_joints(target, weights)
    return torch.linalg.vector_norm(p - t, dim=-1).mean()


def mae_error(pred, target, weights=None) -> torch.Tensor:
    """Coordinate-wise L1, ``cl1``."""
    p, t = _to_joints(pred, weights), _to_joints(target, weights)
    return (p - t).abs().mean()


def mse_error(pred, target, weights=None) -> torch.Tensor:
    """``cl2``: mean(sqrt(d**2)), a mean absolute error."""
    p, t = _to_joints(pred, weights), _to_joints(target, weights)
    return torch.sqrt((p - t) ** 2).mean()


def transition_error(pred, target, weights=None) -> torch.Tensor:
    """Frame-difference MPJPE, ``tl2``."""
    dp = pred[:, 1:] - pred[:, :-1]
    dt = target[:, 1:] - target[:, :-1]
    return mpjpe_error(dp, dt, weights)


def gram_matrix_loss(pred, target, weights=None) -> torch.Tensor:
    """Temporal-pair Gram loss, ``gm2``."""
    del weights
    n, t, vc = pred.shape

    def gram(x):
        g = torch.cat([x[:, 1:], x[:, :-1]], dim=-1) / (n * 2 * t * vc)
        return torch.einsum("nij,nkj->nik", g, g)

    return ((gram(pred) - gram(target)) ** 2).sum()


def make_bone_error(incidence) -> Callable:
    """Bone-length L2 loss over a layout's (V, E) incidence matrix."""
    inc = torch.as_tensor(np.asarray(incidence), dtype=torch.float32)

    def bone_length(x):
        n, t, vc = x.shape
        p = x.reshape(n, t, vc // 3, 3)
        d = torch.einsum("ntvc,ve->ntce", p, inc.to(x.device, x.dtype))
        return torch.linalg.vector_norm(d, dim=2)

    def bone_error(pred, target, weights=None):
        del weights
        return ((bone_length(pred) - bone_length(target)) ** 2).mean()

    return bone_error


def registry(bone_incidence=None) -> Dict[str, Callable]:
    reg = {
        "jl2": mpjpe_error,
        "tl2": transition_error,
        "cl1": mae_error,
        "cl2": mse_error,
        "gm2": gram_matrix_loss,
    }
    if bone_incidence is not None:
        reg["bl2"] = make_bone_error(bone_incidence)
    return reg


class AccumLoss:
    """Running (sum, count) average."""

    def __init__(self):
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.sum += float(val)
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
