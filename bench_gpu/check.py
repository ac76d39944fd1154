"""The numbers that decide ``correct``, and their limits.

Training, twice: the ``checked_steps`` first steps of the set-up, from the
weights at the seed, and the ``checked_steps`` steps that follow the
window (and the traced part) through the same engine, from the program's
own state at that point (its weights, Adam's moments and step count, the
StepLR epoch and the dropout masks drawn so far), each compared with
:func:`reference.train_steps` on the same rows.  The numbers of the steps
after the window carry the prefix ``post_``; ``post_grad_gap`` is worked
out but not compared (its sound readings spread eightfold from seed to
seed after the window and come within 2.4x of the control's):

* ``loss_gap``: the largest relative gap of a step's objective;
* ``grad_gap``: the first step's gradient as the optimizer got it (worked
  out from Adam's first moment before and after that step): each leaf's
  gap of norms over the larger of that leaf's reference norm and the
  median leaf's, over the leaves the reference gives a gradient (at least
  a thousandth of the median leaf's), and of those the upper quartile.
  Not the worst leaf: that is always a one-element leaf (a gate ``alpha``
  or a PReLU slope) whose gradient sums the whole batch's terms with deep
  cancellation, and the reference computed at bf16 reads it as far off as
  the program;
* ``update_gap``: the parameters' change over the steps, the same
  measure, of the median leaf, leaving out leaves whose reference gradient
  is under a thousandth of the median leaf's at some step (they move there
  under Adam by round-off alone);
* ``adam_steps_missed``: the steps fed to the engine less the fewest
  optimizer steps any leaf's Adam state counts, after the window: a step
  of the window that did not reach the optimizer.

Evaluation (answers of the window, compared with
:func:`reference.eval_batch` on the same batches):

* ``pred_gap``: of a sample drawn from the seed of the window's batches,
  the worst sequence's root-mean-square gap of predictions over the
  root-mean-square of the reference's predicted motion over its batch;
* ``mpjpe_gap``: of every ``test`` call of the window (one action), the
  largest relative gap of its MPJPE, the mean of its per-frame errors (the
  engine's returned average).  Not each frame's: the worst of 120 frame
  cells reads the bf16 program within 3x of the fp8 control.

Both loops, on the card: ``off_precision_share``, the share of the
window's DSTD-GC kernel launches that are not of the configuration's
stated precision (1 where the window launched none: the path fell back to
plain PyTorch).

The limits live in ``limits/<loop>.<precision>.json``, one table for each
loop and stated precision, found by name; a cell without its table does
not run.  ``PERF.md`` gives the readings each limit was set from.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch

LIMITS_DIR = Path(__file__).resolve().parent / "limits"


def limits_file(loop: str, precision: str, root: Path = None) -> Path:
    """The limits table of ``loop`` at ``precision`` (in the checkout at
    ``root``; default: this harness's own)."""
    base = LIMITS_DIR if root is None else Path(root) / "bench_gpu" / "limits"
    return base / f"{loop}.{precision}.json"


def limits(loop: str, precision: str, root: Path = None) -> Dict[str, float]:
    """The limit of each compared number of ``loop`` at ``precision``."""
    table = json.loads(limits_file(loop, precision, root).read_text())
    return {k: float(v) for k, v in table["limits"].items()}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def moved_leaves(gnorms: List[Dict[str, float]]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's at every checked step (``gnorms``: each step's gradient
    norm of each leaf).  A leaf under it at some step is moved there by
    round-off alone: Adam scales a gradient of rounding noise to a full
    step."""
    keep = None
    for norms in gnorms:
        med = float(np.median(list(norms.values())))
        ok = {k for k, v in norms.items() if v >= 1e-3 * med}
        keep = ok if keep is None else keep & ok
    return [k for k in gnorms[0] if k in keep] if gnorms else []


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: Iterable[str] = None) -> Dict[str, float]:
    """Each leaf's ``| |got| - |want| |`` over the larger of ``|want|`` and
    the median leaf's ``|want|``."""
    keys = list(want) if keep is None else list(keep)
    g = _norms({k: got[k] for k in keys})
    w = _norms({k: want[k] for k in keys})
    med = float(np.median(list(w.values()))) if w else 0.0
    return {k: abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in keys}


def _quantile(values, q: float) -> float:
    values = list(values)
    if not values:
        return 0.0
    if not all(math.isfinite(v) for v in values):
        return float("inf")
    return float(np.quantile(np.asarray(values, np.float64), q))


def train_gaps(prog: dict, ref: dict) -> Tuple[List[float], Dict[str, float],
                                               Dict[str, float]]:
    """(each step's relative gap of the objective, each graded leaf's gap
    of the first gradient, each kept leaf's gap of the change) of the
    program's readings ``prog`` (``losses``, ``grad1``, ``p0``, ``p_end``)
    against the reference's."""
    losses = [abs(a - b) / max(abs(b), 1e-30)
              for a, b in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]) or not all(
            math.isfinite(x) for x in prog["losses"]):
        losses.append(float("inf"))
    graded = moved_leaves(ref["gnorms"][:1])
    grad = leaf_gaps(prog["grad1"], ref["grad1"], graded)
    keep = moved_leaves(ref["gnorms"])
    update = leaf_gaps({k: prog["p_end"][k] - prog["p0"][k] for k in keep},
                       {k: ref["p_end"][k] - ref["p0"][k] for k in keep},
                       keep)
    return losses, grad, update


def train_numbers(prog: dict, ref: dict, prefix: str = "") -> Dict[str,
                                                                 float]:
    """The compared training numbers (``prefix`` before each name)."""
    losses, grad, update = train_gaps(prog, ref)
    return {prefix + "loss_gap": max(losses),
            prefix + "grad_gap": _quantile(grad.values(), 0.75),
            prefix + "update_gap": _quantile(update.values(), 0.5)}


def train_spread(prog: dict, ref: dict) -> Dict[str, float]:
    """Other statistics of the same leaf gaps (the worst and the median
    leaf of the gradient, the worst and the upper quartile of the change),
    which ``calibrate.py`` reads beside the compared ones."""
    _, grad, update = train_gaps(prog, ref)
    return dict(grad_worst=_quantile(grad.values(), 1.0),
                grad_worst_leaf=max(grad, key=grad.get) if grad else "",
                grad_median=_quantile(grad.values(), 0.5),
                update_worst=_quantile(update.values(), 1.0),
                update_p75=_quantile(update.values(), 0.75))


def off_precision_share(counts: Mapping[str, int], precision: str,
                        variant) -> float:
    """Share of the DSTD-GC launches ``counts`` (by kernel name) whose
    variant (``variant(name)``) is not ``precision``; 1.0 where there
    were none."""
    total = sum(counts.values())
    if not total:
        return 1.0
    return sum(v for k, v in counts.items()
               if variant(k) != precision) / total


def pred_gap(pred: torch.Tensor, want: torch.Tensor,
             motion: torch.Tensor) -> float:
    """Worst sequence's RMS gap of predictions ``pred`` and ``want`` (N,
    frames, joints, 3) over the RMS of the reference's predicted motion
    over the whole batch (N, ...): a sequence that barely moves does not
    shrink its own scale."""
    n = pred.shape[0]
    diff = (pred.double() - want.double()).reshape(n, -1)
    scale = motion.double().pow(2).mean().sqrt().clamp_min(1e-30)
    return float((diff.pow(2).mean(1).sqrt() / scale).max())


def mpjpe_gap(got: np.ndarray, want: np.ndarray) -> float:
    """Relative gap of two MPJPEs, each the mean of its per-frame errors."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return float("inf")
    return float(abs(got.mean() - want.mean()) / max(abs(want.mean()),
                                                      1e-30))


def judge(numbers: Dict[str, float], table: Dict[str, float]) -> Tuple[
        bool, Dict[str, dict]]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {k: dict(value=float(numbers[k]), limit=table[k])
              for k in table}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
