"""Reference-checkpoint migration: a state_dict of the original PyTorch
DSTD-GCN -> the port's :class:`..models.DSTDGCN` state.

Counterpart of ``dstdgcn_tpu/utils/convert.py``, with its name map
(reference -> port, the flax tree's names joined by dots):

  conv_st_in.stgcn.0.0         -> conv_st_in.block        (DSTDGCB)
  encoders.{i}.0.stgcn.0.0     -> encoder_{i}.block
  encoders.{i}.1 / .2          -> encoder_bn_{i} / encoder_prelu_{i}
  conv_st_out.stgcn.0.0        -> conv_st_out.block
  bn_in / prelu                -> bn_in / prelu

Within a DSTDGCB, the K per-kernel ``conv_s.{k}`` / ``conv_t.{k}`` units are
stacked along a leading kernel axis; 1x1 conv weights ``(Co, Ci, 1, 1)``
become dense kernels ``(Ci, Co)``; ``conv_rm`` weights ``(ref, R*ref, 1, 1)``
become ``(R, ref, ref)``; BatchNorm1d(C*V) vectors reshape to ``(V, C)``
(c-major in the qualitative model, v-major in the fast one).

:func:`load_torch_state_dict` reads both ``.pth`` formats the reference
writes; :func:`torch_state_to_flax` gives the JAX function's tree as numpy
arrays and :func:`torch_state_to_port` the port's state dict, which
``model.load_state_dict`` takes; :func:`load_reference_checkpoint` does
all three for a model.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .bridge import flatten_tree

__all__ = ["load_torch_state_dict", "torch_state_to_flax",
           "torch_state_to_port", "load_reference_checkpoint"]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a reference checkpoint (``.pth``) into numpy arrays.

    Accepts either a bare model state_dict or the engine checkpoint dict
    ``{lr, err, model, optimizer, scheduler, epoch}`` written by the
    reference engine; the wrapper prefix ``model.`` added by the reference
    ModelWrapper is stripped.
    """
    state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "model" in state and not hasattr(
            state["model"], "shape"):
        state = state["model"]
    out = {}
    for k, v in state.items():
        if k.startswith("model."):
            k = k[len("model."):]
        if hasattr(v, "numpy"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def _conv1x1(w: np.ndarray) -> np.ndarray:
    """(Co, Ci, 1, 1) conv weight -> (Ci, Co) dense kernel."""
    if w.ndim == 4:
        w = w[:, :, 0, 0]
    return np.ascontiguousarray(w.T)


def _rm(w: np.ndarray, red: int = 2) -> np.ndarray:
    """conv_rm weight (ref, R*ref, 1, 1) -> (R, ref_in, ref_out)."""
    if w.ndim == 4:
        w = w[:, :, 0, 0]
    ref_out, rin = w.shape
    # w[t, r*ref_in + s] -> wrm[r, s, t]
    return np.ascontiguousarray(
        w.reshape(ref_out, red, rin // red).transpose(1, 2, 0))


def _bn_vec(v: np.ndarray, joints: int, fast: bool = False) -> np.ndarray:
    """BatchNorm1d(C*V) vector -> (V, C): index c*V + v in the qualitative
    model, v*C + c in the fast one."""
    if fast:
        return np.ascontiguousarray(v.reshape(joints, -1))
    return np.ascontiguousarray(v.reshape(v.shape[0] // joints, joints).T)


def _dstdgc(sd, prefix: str, n_kernels: int, red: int = 2) -> Dict:
    def stack(name, conv):
        return np.stack([conv(sd[f"{prefix}.{k}.{name}"])
                         for k in range(n_kernels)])

    return {
        "wf": stack("conv_f.weight", _conv1x1),
        "bf": stack("conv_f.bias", np.asarray),
        "wm1": stack("conv_m1.weight", _conv1x1),
        "bm1": stack("conv_m1.bias", np.asarray),
        "wm2": stack("conv_m2.weight", _conv1x1),
        "bm2": stack("conv_m2.bias", np.asarray),
        "wrm": stack("conv_rm.weight", lambda w: _rm(w, red)),
        "brm": stack("conv_rm.bias", np.asarray),
    }


def _bn(sd, prefix: str, joints: int, fast: bool):
    """(params, statistics) of the BatchNorm1d at ``prefix``."""
    def vec(name):
        return _bn_vec(sd[f"{prefix}.{name}"], joints, fast)

    return ({"scale": vec("weight"), "bias": vec("bias")},
            {"mean": vec("running_mean"), "var": vec("running_var")})


def _block(sd, tprefix: str, joints: int, fast: bool):
    """(params, statistics) of one DSTDGCB (reference prefix ``tprefix``)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    if fast:
        params["A_s"] = sd[f"{tprefix}.A_s"]
    else:
        params["W_s"] = sd[f"{tprefix}.W_s"]
        params["R_s"] = sd[f"{tprefix}.R_s"]
    n_s = (params["A_s"] if fast else params["W_s"]).shape[0]
    params["R_t"] = sd[f"{tprefix}.R_t"]
    params["alpha_sm"] = sd[f"{tprefix}.alpha_sm"]
    params["alpha_tm"] = sd[f"{tprefix}.alpha_tm"]
    params["spatial"] = _dstdgc(sd, f"{tprefix}.conv_s", n_s)
    params["temporal"] = _dstdgc(sd, f"{tprefix}.conv_t",
                                 params["R_t"].shape[0])
    params["bn"], stats["bn"] = _bn(sd, f"{tprefix}.bn.bn", joints, fast)
    params["prelu"] = {"negative_slope": sd[f"{tprefix}.prelu.weight"]
                       .reshape(())}
    if f"{tprefix}.residual.0.weight" in sd:
        params["residual_proj"] = {
            "kernel": _conv1x1(sd[f"{tprefix}.residual.0.weight"]),
            "bias": sd[f"{tprefix}.residual.0.bias"],
        }
        params["residual_bn"], stats["residual_bn"] = _bn(
            sd, f"{tprefix}.residual.1.bn", joints, fast)
    return params, stats


def torch_state_to_flax(sd: Dict[str, np.ndarray], num_layers: int,
                        joints: int, fast: bool = False) -> Dict[str, Any]:
    """``{"params": tree, "batch_stats": tree}`` of float32 numpy arrays
    from a reference state_dict (numpy arrays): the tree of the JAX
    function of the same name, which :func:`..utils.bridge.
    load_flax_variables` loads."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(name, tprefix):
        p, s = _block(sd, tprefix, joints, fast)
        params[name], stats[name] = {"block": p}, {"block": s}

    put("conv_st_in", "conv_st_in.stgcn.0.0")
    for i in range(num_layers):
        put(f"encoder_{i}", f"encoders.{i}.0.stgcn.0.0")
        params[f"encoder_bn_{i}"], stats[f"encoder_bn_{i}"] = _bn(
            sd, f"encoders.{i}.1.bn", joints, fast)
        params[f"encoder_prelu_{i}"] = {
            "negative_slope": sd[f"encoders.{i}.2.weight"].reshape(())}
    put("conv_st_out", "conv_st_out.stgcn.0.0")
    params["bn_in"], stats["bn_in"] = _bn(sd, "bn_in.bn", joints, fast)
    params["prelu"] = {"negative_slope": sd["prelu.weight"].reshape(())}

    def copy(tree):   # own float32 arrays, no view of the state_dict
        return {k: copy(v) if isinstance(v, dict)
                else np.array(v, dtype=np.float32, copy=True)
                for k, v in tree.items()}

    return {"params": copy(params), "batch_stats": copy(stats)}


def torch_state_to_port(sd: Dict[str, np.ndarray], num_layers: int,
                        joints: int, fast: bool = False) \
        -> Dict[str, torch.Tensor]:
    """The port's DSTDGCN state dict (``model.load_state_dict`` takes it)
    from a reference state_dict: :func:`torch_state_to_flax` with each
    leaf named by its path joined with dots, parameters and statistics in
    one dict."""
    variables = torch_state_to_flax(sd, num_layers, joints, fast)
    flat = flatten_tree(variables["params"])
    flat.update(flatten_tree(variables["batch_stats"]))
    return {k: torch.from_numpy(v) for k, v in flat.items()}


def load_reference_checkpoint(model, path: str) -> None:
    """Load a reference ``.pth`` (either format) into ``model``, a
    :class:`..models.DSTDGCN` of the checkpoint's layout, in place."""
    model.load_state_dict(torch_state_to_port(
        load_torch_state_dict(path), model.num_layers,
        model.joints_to_consider, model.fast))
