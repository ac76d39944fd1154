"""Plain PyTorch Graph WaveNet: the reference the benchmark holds the port's
``gwnet`` to (a frozen copy of ``references/gwnet.py``, so that a later
change there cannot move the yardstick).

Written from ``model.py::gwnet``, ``engine.py`` and ``util.py`` of the
authors' code (github.com/nnzhan/Graph-WaveNet) as plain functions over a
dict of parameters, in float32 with TF32 off (the caller's
``torch.backends`` flags; :func:`strict_float32` sets them).  It imports
nothing of the port and takes nothing the port has made but what it is
given:

* the road graph's weighted adjacency, in the caller's node order; the
  supports are dense: ``doubletransition``'s ``D_out^-1 A`` and
  ``D_in^-1 A^T`` (``util.py::asym_adj``), and the adaptive
  ``softmax(relu(E1 E2), dim=1)``, each hop ``nconv``'s einsum;
* the parameters, drawn from ``torch.Generator().manual_seed(seed)`` in the
  order of :func:`param_specs` (the port documents the same order):
  ``nodevec1`` and ``nodevec2`` standard normal, each convolution's weight
  and bias uniform within ``1 / sqrt(fan_in)`` (torch's default
  initialisation of a convolution), the BatchNorms at one and zero;
* dropout masks from a generator on the device seeded ``seed + 1``: one
  ``torch.rand`` of each layer's ``(N, C, V, L)`` shape a forward, kept
  where at least ``p``, in layer order.

The training step is ``engine.py::trainer.train``: the prediction
de-normalised by the z-score scaler of the reading, ``util.py::masked_mae``
against the raw reading with null value 0, the gradient clipped to norm
``clip`` (``torch.nn.utils.clip_grad_norm_``), then Adam (betas 0.9 /
0.999, eps 1e-8, L2 weight decay added to the gradient).

Departures from ``model.py``, none of which changes a result: the gate
convolution is a ``conv2d`` (``model.py``'s ``nn.Conv1d`` with kernel (1, 2)
computes the same); ``residual_convs`` are left out (built there, never
called with the graph convolution on); the input is the dataset's ``(N, T,
V, C_in)`` and the output ``(N, out_dim, V)``; the graph is synthetic (drawn
by the caller).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def strict_float32() -> None:
    """Turn TF32 off for cuBLAS products and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def transitions(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``util.py::asym_adj`` of ``adj`` and of its transpose: each row
    divided by its sum (a zero row stays zero), float32."""
    out = []
    for a in (np.asarray(adj, np.float64), np.asarray(adj, np.float64).T):
        d = a.sum(1)
        inv = np.divide(1.0, d, out=np.zeros_like(d), where=d != 0)
        out.append((inv[:, None] * a).astype(np.float32))
    return out[0], out[1]


def dilations(hp: dict) -> List[int]:
    """The dilation of each layer: 1, 2, 4, ... within each block."""
    return [2 ** i for _ in range(int(hp.get("blocks", 4)))
            for i in range(int(hp.get("layers", 2)))]


def receptive_field(hp: dict) -> int:
    k = int(hp.get("kernel_size", 2))
    return 1 + sum((k - 1) * d for d in dilations(hp))


def param_specs(hp: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter in drawing order; ``kind``
    is ``normal``, ``one``, ``zero`` or ``uniform:<fan_in>``."""
    v = int(hp["joints_to_consider"])
    e = int(hp.get("embedding", 10))
    cin = int(hp.get("in_dim", 3))
    r = int(hp.get("residual_channels", 32))
    d = int(hp.get("dilation_channels", 32))
    sk = int(hp.get("skip_channels", 256))
    end = int(hp.get("end_channels", 512))
    out = int(hp["output_time_frame"])
    k = int(hp.get("kernel_size", 2))
    hops = int(hp.get("order", 2)) * 3 + 1
    n = len(dilations(hp))
    specs = [("nodevec1", (v, e), "normal"), ("nodevec2", (e, v), "normal")]

    def conv(name, ci, co, kw=1):
        fan = f"uniform:{ci * kw}"
        specs.append((name + ".weight", (co, ci, 1, kw), fan))
        specs.append((name + ".bias", (co,), fan))

    conv("start_conv", cin, r)
    for group in ("filter_convs", "gate_convs"):
        for i in range(n):
            conv(f"{group}.{i}", r, d, k)
    for i in range(n):
        conv(f"skip_convs.{i}", d, sk)
    for i in range(n):
        specs.append((f"bn.{i}.weight", (r,), "one"))
        specs.append((f"bn.{i}.bias", (r,), "zero"))
    for i in range(n):
        conv(f"gconv.{i}.mlp.mlp", hops * d, r)
    conv("end_conv_1", sk, end)
    conv("end_conv_2", end, out)
    return specs


def init_params(hp: dict, seed: int) -> Params:
    """The parameters at ``seed``, float32 on the CPU."""
    g = torch.Generator().manual_seed(int(seed))
    p: Params = {}
    for name, shape, kind in param_specs(hp):
        t = torch.empty(shape)
        if kind == "normal":
            t.normal_(generator=g)
        elif kind in ("one", "zero"):
            t.fill_(1.0 if kind == "one" else 0.0)
        else:
            bound = 1.0 / math.sqrt(int(kind.split(":")[1]))
            t.uniform_(-bound, bound, generator=g)
        p[name] = t
    return p


def nconv(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.einsum("ncvl,vw->ncwl", x, a).contiguous()


def forward(p: Params, hp: dict, supports: Sequence[torch.Tensor],
            x: torch.Tensor,
            gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """A training forward, (N, T, V, C_in) -> (N, out_dim, V), normalised:
    the BatchNorms on the batch's statistics; ``supports`` the two dense
    road transitions; ``gen`` draws the dropout masks (none without it)."""
    order = int(hp.get("order", 2))
    drop = float(hp.get("dropout", 0.3))
    x = x.permute(0, 3, 2, 1)
    rf = receptive_field(hp)
    if x.shape[3] < rf:
        x = F.pad(x, (rf - x.shape[3], 0, 0, 0))

    def conv(t, name, dilation=1):
        return F.conv2d(t, p[name + ".weight"], p[name + ".bias"],
                        dilation=(1, dilation))

    x = conv(x, "start_conv")
    adp = F.softmax(F.relu(torch.mm(p["nodevec1"], p["nodevec2"])), dim=1)
    sup = list(supports) + [adp]
    skip = 0
    for i, d in enumerate(dilations(hp)):
        residual = x
        x = torch.tanh(conv(residual, f"filter_convs.{i}", d)) * \
            torch.sigmoid(conv(residual, f"gate_convs.{i}", d))
        s = conv(x, f"skip_convs.{i}")
        skip = s + (skip[:, :, :, -s.shape[3]:] if i else 0)
        out = [x]
        for a in sup:
            x1 = nconv(x, a)
            out.append(x1)
            for _ in range(2, order + 1):
                x1 = nconv(x1, a)
                out.append(x1)
        h = conv(torch.cat(out, dim=1), f"gconv.{i}.mlp.mlp")
        if gen is not None and drop > 0:
            keep = torch.rand(h.shape, generator=gen,
                              device=gen.device) >= drop
            h = h * keep.to(device=h.device, dtype=h.dtype) / (1 - drop)
        x = h + residual[:, :, :, -h.shape[3]:]
        x = F.batch_norm(x, None, None, p[f"bn.{i}.weight"],
                         p[f"bn.{i}.bias"], training=True, eps=1e-5)
    x = F.relu(conv(F.relu(skip), "end_conv_1"))
    return conv(x, "end_conv_2")[..., -1]


def masked_mae(pred: torch.Tensor, target: torch.Tensor,
               null_val: float = 0.0) -> torch.Tensor:
    """``util.py::masked_mae``: the mean absolute error over the readings
    that are not ``null_val``, weighted so that the mean is over them."""
    mask = (target != null_val).float()
    mask = mask / torch.mean(mask)
    mask = torch.where(torch.isnan(mask), torch.zeros_like(mask), mask)
    loss = torch.abs(pred - target) * mask
    loss = torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
    return torch.mean(loss)


def step_loss(p: Params, hp: dict, supports, batch, scaler, gen=None):
    """The objective of one batch: ``batch`` (x normalised (N, T, V, C_in),
    y the raw reading (N, out_dim, V)); ``scaler`` (mean, std) of the
    reading."""
    x, y = batch
    pred = forward(p, hp, supports, x, gen)
    mean, std = scaler
    return masked_mae(pred * std + mean, y)


def train_steps(p0: Params, hp: dict, supports, batches, scaler,
                device, lr: float = 1e-3, weight_decay: float = 1e-4,
                clip: float = 5.0, gen: Optional[torch.Generator] = None,
                exp_avg: Optional[Params] = None,
                exp_avg_sq: Optional[Params] = None,
                steps: int = 0) -> dict:
    """Adam steps over ``batches`` from the parameters ``p0`` (and Adam's
    moments and step count, zero by default): returns the objective of
    each step, the first step's gradient as Adam gets it (clipped, the
    decay added), each step's gradient norm of each parameter, and the
    parameters before and after (on the CPU)."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    p = {k: v.to(device, copy=True).requires_grad_(True)
         for k, v in p0.items()}
    m = {k: exp_avg[k].to(device, copy=True) if exp_avg is not None
         else torch.zeros_like(v) for k, v in p.items()}
    s = {k: exp_avg_sq[k].to(device, copy=True) if exp_avg_sq is not None
         else torch.zeros_like(v) for k, v in p.items()}
    losses, grad1, gnorms = [], {}, []
    for step, batch in enumerate(batches, start=steps + 1):
        loss = step_loss(p, hp, supports, batch, scaler, gen)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        grads = [torch.zeros_like(v) if g is None else g
                 for v, g in zip(p.values(), grads)]
        losses.append(float(loss.detach()))
        gnorms.append({})
        with torch.no_grad():
            total = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            coef = torch.clamp(clip / (total + 1e-6), max=1.0)
            for (k, v), g in zip(p.items(), grads):
                g = g * coef + weight_decay * v
                if step == steps + 1:
                    grad1[k] = g.detach().cpu()
                gnorms[-1][k] = float(g.norm())
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                s[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (s[k].sqrt() / math.sqrt(1 - b2 ** step)).add_(eps)
                v.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** step))
    return dict(losses=losses, grad1=grad1, gnorms=gnorms,
                p0={k: v.detach().cpu().clone() for k, v in p0.items()},
                p_end={k: v.detach().cpu() for k, v in p.items()})
