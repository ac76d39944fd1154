"""Plain PyTorch DSTD-GCN: the reference the benchmark holds the port to.

Written from the DSTD-GCN paper (TNNLS 2024) and the equations of the
plain ops it shares with the port (a frozen copy of their arithmetic, not
an import): channels-last ``(N, T, V, C)`` activations, an in-layer, the
residual encoder layers and an out-layer, each a DSTD-GC block (spatial op,
BatchNorm, residual, PReLU, temporal op), the motion decomposition at the
input and the last observed frame added back at the output.  It imports
nothing of the port and takes nothing the port has made: the weights are
drawn again from the seed in the port's documented order
(``torch.Generator().manual_seed(seed)``, Kaiming-normal fan-out draws in
module order), the static graphs are built from the configuration's edge
lists, and the dropout masks are drawn again from a generator on the
device seeded ``seed + 1``, one ``torch.rand`` of the activation's shape a
forward, as the port documents it.

``rounding`` selects where precision is lost: ``None`` computes in float32
throughout (the reference); a function ``q`` rounds, as the port's bf16
path does, the operands of the four contractions of every op (``x wqk``,
``x wf``, ``s wrm``, ``adj xf``), the ops' outputs and the block
BatchNorms' outputs, and, through :class:`_Round`, the cotangents at the
same points in the backward pass.  :func:`bf16` and :func:`fp8` are the
two roundings the benchmark uses: bf16 is the configuration's stated
precision, fp8 (e4m3, one scale a tensor) the next precision below it,
the correctness control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

Rounding = Optional[Callable[[torch.Tensor], torch.Tensor]]


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back."""
    return x.to(torch.bfloat16).to(x.dtype)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its largest
    magnitude at the format's largest value, 448), and back."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Round(torch.autograd.Function):
    """``q(x)`` forward and ``q(g)`` backward."""

    @staticmethod
    def forward(ctx, x, q):
        ctx.q = q
        return q(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.q(g), None


def _r(x: torch.Tensor, q: Rounding) -> torch.Tensor:
    return x if q is None else _Round.apply(x, q)


# -- graphs -----------------------------------------------------------------


def spatial_graph(graph: dict) -> np.ndarray:
    """(2, V, V) [connect, part]: identity plus the symmetric bone edges,
    and the symmetric part edges, over the used joints in model order."""
    used = list(graph["used_joints"])
    index = {j: i for i, j in enumerate(used)}
    v = len(used)
    connect = np.eye(v, dtype=np.float32)
    part = np.zeros((v, v), np.float32)
    for adj, key in ((connect, "bone_pairs"), (part, "part_pairs")):
        for a, b in graph[key]:
            adj[index[a], index[b]] = adj[index[b], index[a]] = 1.0
    return np.stack([connect, part])


def temporal_graph(t: int) -> np.ndarray:
    """(1, T, T) frame graph as the published code builds it: the identity
    overwritten by two block assignments (the sub-diagonal all ones, the
    main diagonal only at both ends, the super-diagonal only at (0, 1) and
    (T-2, T-1))."""
    adj = np.eye(t, dtype=np.float32)
    adj[:-1, 1:] = np.eye(t - 1, dtype=np.float32)
    adj[1:, :-1] = np.eye(t - 1, dtype=np.float32)
    return adj[None]


# -- weights ----------------------------------------------------------------


def hyper(config: dict) -> dict:
    """The model's hyper-parameters (the model block's entry of its
    name)."""
    return config["model"][config["model"]["name"]]


def _layer_widths(model: dict) -> List[Tuple[str, int, int, bool]]:
    """(name, Ci, Co, outer residual) of each layer, in module order."""
    cin, f, n = (int(model["input_channels"]), int(model["num_feature"]),
                 int(model["num_layers"]))
    return ([("conv_st_in", cin, f, False)]
            + [(f"encoder_{i}", f, f, True) for i in range(n)]
            + [("conv_st_out", f, cin // 2, False)])


def init_params(config: dict, seed: int) -> Dict[str, torch.Tensor]:
    """The model's parameters at ``seed``, float32 on the CPU, named as the
    port names them."""
    model, graph = hyper(config), config["graph"]
    t = int(model["input_time_frame"]) + int(model["output_time_frame"])
    v = int(model["joints_to_consider"])
    g = torch.Generator().manual_seed(int(seed))
    a_s = torch.from_numpy(spatial_graph(graph))
    p: Dict[str, torch.Tensor] = {}

    def normal(shape, fan):
        return torch.empty(shape).normal_(0.0, math.sqrt(2.0 / fan),
                                          generator=g)

    def op(prefix, ci, co, k, ref):
        p[prefix + "wf"] = normal((k, ci, co), co)
        p[prefix + "bf"] = torch.zeros(k, co)
        p[prefix + "wm1"] = normal((k, ci, 2), 2)
        p[prefix + "bm1"] = torch.zeros(k, 2)
        p[prefix + "wm2"] = normal((k, ci, 2), 2)
        p[prefix + "bm2"] = torch.zeros(k, 2)
        p[prefix + "wrm"] = normal((k, 2, ref, ref), ref)
        p[prefix + "brm"] = torch.zeros(k, ref)

    def bn(prefix, c):
        p[prefix + "scale"] = torch.ones(v, c)
        p[prefix + "bias"] = torch.zeros(v, c)

    f = int(model["num_feature"])
    for name, ci, co, _ in _layer_widths(model):
        b = f"{name}.block."
        p[b + "W_s"] = torch.zeros_like(a_s)
        p[b + "R_s"] = a_s.clone()
        p[b + "R_t"] = torch.zeros(1, t, t)
        p[b + "alpha_sm"] = torch.zeros(1)
        p[b + "alpha_tm"] = torch.zeros(1)
        if ci != co:
            p[b + "residual_proj.kernel"] = normal((ci, co), co)
            p[b + "residual_proj.bias"] = torch.zeros(co)
            bn(b + "residual_bn.", co)
        op(b + "spatial.", ci, co, 2, t)
        bn(b + "bn.", co)
        p[b + "prelu.negative_slope"] = torch.tensor(0.25)
        op(b + "temporal.", co, co, 1, v)
        if name == "conv_st_in":
            bn("bn_in.", f)
            p["prelu.negative_slope"] = torch.tensor(0.25)
        elif name.startswith("encoder_"):
            i = name.split("_")[1]
            bn(f"encoder_bn_{i}.", f)
            p[f"encoder_prelu_{i}.negative_slope"] = torch.tensor(0.25)
    return p


# -- the model ---------------------------------------------------------------


def dstd_op(mode: str, x, base, alpha, w: Dict[str, torch.Tensor],
            q: Rounding) -> torch.Tensor:
    """One DSTD-GC op (right aggregation): x (N,T,V,Ci) -> (N,T,V,Co).
    Scores ``tanh(q_i - k_j)`` over joint pairs of a frame (spatial) or
    frame pairs of a joint (temporal), mixed over (R, source frame or
    joint) into a dynamic adjacency, gated by ``alpha`` and added to the
    static ``base``; the feature projection aggregated over it."""
    xr = _r(x, q)
    lay = "rtv" if mode == "spatial" else "rvt"
    qq = torch.einsum(f"ntvc,kcr->kn{lay}", xr, _r(w["wm1"], q)) \
        + w["bm1"][:, None, :, None, None]
    kk = torch.einsum(f"ntvc,kcr->kn{lay}", xr, _r(w["wm2"], q)) \
        + w["bm2"][:, None, :, None, None]
    s = torch.tanh(qq[..., :, None] - kk[..., None, :])
    dyn = torch.einsum("knrsij,krso->knoij", _r(s, q), _r(w["wrm"], q)) \
        + w["brm"][:, None, :, None, None]
    adj = dyn * alpha.reshape(()) + base[:, None, None]
    xf = torch.einsum("ntvc,kcd->kntvd", xr, _r(w["wf"], q)) \
        + w["bf"][:, None, None, None, :]
    if mode == "spatial":
        out = torch.einsum("kntvc,kntvw->ntwc", _r(xf, q), _r(adj, q))
    else:
        out = torch.einsum("kntvc,knvtu->nuvc", _r(xf, q), _r(adj, q))
    return _r(out, q)


def batch_norm(x, p, prefix, train: bool, stats: Optional[dict] = None,
               eps: float = 1e-5, momentum: float = 0.1):
    """Per-(joint, channel) BatchNorm over batch and time: the batch's
    statistics in training (biased variance), else the running ones.
    ``stats`` holds the running (mean, variance) of each BatchNorm by its
    prefix (absent: the initial 0 and 1); a training forward updates them
    with the momentum and the unbiased variance."""
    x = x.float()
    if train:
        mean = x.mean(dim=(0, 1))
        var = (x * x).mean(dim=(0, 1)) - mean * mean
        if stats is not None:
            cnt = x.shape[0] * x.shape[1]
            run_mean, run_var = stats.get(prefix, (0.0, 1.0))
            with torch.no_grad():
                stats[prefix] = (
                    (1 - momentum) * run_mean + momentum * mean,
                    (1 - momentum) * run_var
                    + momentum * var * (cnt / max(cnt - 1, 1)))
    elif stats is not None and prefix in stats:
        mean, var = stats[prefix]
    else:
        mean, var = torch.zeros_like(p[prefix + "scale"]), \
            torch.ones_like(p[prefix + "scale"])
    return (x - mean) * (torch.rsqrt(var + eps) * p[prefix + "scale"]) \
        + p[prefix + "bias"]


def prelu(x, a):
    return torch.where(x >= 0, x, a * x)


def block(x, p, name, a_t, train: bool, q: Rounding, stats=None):
    b = f"{name}.block."
    w = lambda m: {k[len(b + m) + 1:]: t for k, t in p.items()   # noqa: E731
                   if k.startswith(b + m + ".")}
    base_s = p[b + "R_s"].detach() * p[b + "W_s"] + p[b + "R_s"]
    base_t = a_t + p[b + "R_t"]
    if b + "residual_proj.kernel" in p:
        res = x @ p[b + "residual_proj.kernel"] + p[b + "residual_proj.bias"]
        res = _r(batch_norm(res, p, b + "residual_bn.", train, stats), q)
    else:
        res = x
    y = dstd_op("spatial", x, base_s, p[b + "alpha_sm"], w("spatial"), q)
    y = _r(batch_norm(y, p, b + "bn.", train, stats), q) + res
    if b + "residual_proj.kernel" in p:     # a sum of two rounded values
        y = _r(y, q)
    y = prelu(y, p[b + "prelu.negative_slope"])
    return dstd_op("temporal", y, base_t, p[b + "alpha_tm"], w("temporal"), q)


def forward(p, config: dict, x, train: bool, q: Rounding = None,
            dropout: Optional[torch.Generator] = None,
            stats: Optional[dict] = None) -> Tuple:
    """(output, motion): x (N,T,V,3) -> the model's (N,T,V,3) output and
    the out-layer's part of it (the predicted motion before the last
    observed frame is added back).  ``dropout``: the mask generator of a
    training forward; ``stats``: the BatchNorms' running statistics
    (:func:`batch_norm`)."""
    model = hyper(config)
    t = x.shape[1]
    a_t = torch.from_numpy(temporal_graph(t)).to(x.device)
    residual = x[:, -1:]
    h = torch.cat([x, x - residual], dim=-1)
    h = block(h, p, "conv_st_in", a_t, train, q, stats)
    h = prelu(batch_norm(h, p, "bn_in.", train, stats),
              p["prelu.negative_slope"])
    rate = float(model["st_gcnn_dropout"])
    if train and rate > 0:
        keep = torch.rand(h.shape, generator=dropout,
                          device=dropout.device) >= rate
        h = h * keep.to(h.dtype) / (1 - rate)
    for i in range(int(model["num_layers"])):
        h = block(h, p, f"encoder_{i}", a_t, train, q, stats) + h
        h = prelu(batch_norm(h, p, f"encoder_bn_{i}.", train, stats),
                  p[f"encoder_prelu_{i}.negative_slope"])
    motion = block(h, p, "conv_st_out", a_t, train, q, stats).to(x.dtype)
    return motion + residual, motion


def mpjpe(pred, target) -> torch.Tensor:
    """Mean per-joint L2 error of flat (N, T, V * 3) sequences."""
    n, t, vc = pred.shape
    return torch.linalg.vector_norm(
        (pred - target).reshape(n, t, vc // 3, 3), dim=-1).mean()


def step_loss(p, config, batch, device, q: Rounding, dropout):
    """The training objective of one batch: the joint L2 loss of the
    forward sequence and, with inverse training, of the time-reversed one
    against the reversed targets, halved."""
    inputs, inputs_inv, targets = (torch.as_tensor(a, device=device)
                                   for a in batch[:3])

    def one(x, tgt):
        n, t, vc = x.shape
        out, _ = forward(p, config, x.reshape(n, t, vc // 3, 3), True, q,
                         dropout)
        return mpjpe(out.reshape(n, t, vc), tgt)

    loss = one(inputs, targets)
    if config["engine"].get("inverse", False):
        loss = (loss + one(inputs_inv, targets.flip(1))) / 2
    return loss


def train_steps(config: dict, seed: int, batches, device,
                q: Rounding = None, loss_fn=None, start: dict = None) -> dict:
    """Adam (torch's defaults: betas 0.9 / 0.999, eps 1e-8; L2 weight decay
    added to the gradient) over ``batches`` at the StepLR learning rate of
    the epoch they run in; no clip.  From the weights at ``seed``, Adam's
    moments at zero and the dropout generator (seeded ``seed + 1`` on the
    device) fresh, in epoch 0; or from ``start``: ``params`` and Adam's
    ``exp_avg``, ``exp_avg_sq`` (by name, on the CPU) and ``steps``, the
    ``epoch`` and the ``forwards`` whose dropout masks were drawn before
    (drawn again here and dropped).  Returns the objective of each step,
    the first step's gradient of each parameter, the norm of each
    parameter's gradient at each step, and the weights before and after
    the steps (on the CPU)."""
    learn = config["engine"]["learn"]
    wd = float(learn.get("weight_decay", 0.0))
    b1, b2, eps = 0.9, 0.999, 1e-8
    start = start or {}
    epoch = int(start.get("epoch", 0))
    lr = float(learn["lr"]) * float(learn.get("gamma", 1.0)) ** (
        epoch // int(learn.get("step_size", 1)))
    p0 = start["params"] if "params" in start else init_params(config, seed)
    p = {k: v.to(device, copy=True).requires_grad_(True)
         for k, v in p0.items()}
    m = {k: start["exp_avg"][k].to(device, copy=True) if "exp_avg" in start
         else torch.zeros_like(v) for k, v in p.items()}
    s = {k: start["exp_avg_sq"][k].to(device, copy=True)
         if "exp_avg_sq" in start else torch.zeros_like(v)
         for k, v in p.items()}
    steps = int(start.get("steps", 0))
    gen = torch.Generator(device).manual_seed(int(seed) + 1)
    if start.get("forwards"):
        _skip_masks(config, gen, batches[0], int(start["forwards"]))
    losses, grad1, gnorms = [], {}, []
    for step, batch in enumerate(batches, start=steps + 1):
        loss = (loss_fn or step_loss)(p, config, batch, device, q, gen)
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        losses.append(float(loss.detach()))
        gnorms.append({})
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                g = torch.zeros_like(v) if g is None else g
                if wd:
                    g = g + wd * v
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


def _skip_masks(config: dict, gen: torch.Generator, batch, forwards: int):
    """Draw and drop the dropout masks of ``forwards`` training forwards
    (one ``torch.rand`` of the in-layer's output shape each) from ``gen``:
    the masks the steps before drew."""
    model = hyper(config)
    if float(model["st_gcnn_dropout"]) <= 0:
        return
    n, t = np.shape(batch[0])[:2]
    shape = (n, t, int(model["joints_to_consider"]),
             int(model["num_feature"]))
    for _ in range(forwards):
        torch.rand(shape, generator=gen, device=gen.device)


@torch.no_grad()
def running_statistics(p, config: dict, seed: int, batches, device,
                       q: Rounding = None) -> dict:
    """The BatchNorms' running statistics after training-mode forwards (no
    gradient, dropout from the generator seeded ``seed + 1`` on the
    device) over ``batches`` from their initial values."""
    stats: dict = {}
    gen = torch.Generator(device).manual_seed(int(seed) + 1)
    for batch in batches:
        x = torch.as_tensor(batch[0], device=device)
        n, t, vc = x.shape
        forward(p, config, x.reshape(n, t, vc // 3, 3), True, q, gen, stats)
    return stats


@torch.no_grad()
def eval_batch(p, config: dict, batch, device, q: Rounding = None,
               stats: Optional[dict] = None):
    """(predictions (N, output_n, V_full, 3), per-eval-frame error summed
    over the batch, motion) of one test batch, as the engine's evaluation
    computes them: the output scattered into the full skeleton over the
    used columns, the ignored joints copied from their equals, the
    per-joint L2 error of the eval frames averaged over joints and batch
    (times the batch size)."""
    setting = config["setting"]
    input_n = int(setting["input_n"])
    inputs = torch.as_tensor(batch[0], device=device)
    all_seqs = torch.as_tensor(batch[3], device=device)
    n, t, vc = inputs.shape
    out, motion = forward(p, config, inputs.reshape(n, t, vc // 3, 3),
                          False, q, stats=stats)
    du = torch.as_tensor(np.asarray(setting["dim_used"]), device=device)
    pred = all_seqs.clone()
    pred[:, :, du] = out.reshape(n, t, vc)
    ji = np.asarray(setting["joint_to_ignore"])
    je = np.asarray(setting["joint_to_equal"])
    ii = torch.as_tensor(np.concatenate([ji * 3, ji * 3 + 1, ji * 3 + 2]),
                         device=device)
    ie = torch.as_tensor(np.concatenate([je * 3, je * 3 + 1, je * 3 + 2]),
                         device=device)
    pred[:, :, ii] = pred[:, :, ie]
    pred_p = pred.reshape(n, t, -1, 3)[:, input_n:]
    targ_p = all_seqs.reshape(n, t, -1, 3)[:, input_n:]
    ef = torch.as_tensor(setting["eval_frame"], device=device)
    d = torch.linalg.vector_norm(pred_p[:, ef] - targ_p[:, ef], dim=-1)
    return pred_p, d.mean(dim=(0, 2)) * n, motion
