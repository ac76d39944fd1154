"""Weight bridge between the JAX package's variables and the port's models.

The JAX model's variables are ``{"params": tree, "batch_stats": tree}``;
hand them over as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, variables)``).  The port names its submodules,
parameters and buffers after the flax tree (``encoder_0.block.spatial.wf``,
``encoder_bn_0.mean``), so loading is a flatten-and-copy that fails on any
missing, extra or mis-shaped key; :func:`to_flax_variables` is the
reverse (parameters to ``params``, BatchNorm statistics to
``batch_stats``).  No JAX import is needed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["flatten_tree", "load_flax_variables", "to_flax_variables"]


def flatten_tree(tree: Mapping[str, Any], prefix: str = "") \
        -> Dict[str, np.ndarray]:
    """Nested mapping -> {"a.b.c": leaf}."""
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flatten_tree(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def load_flax_variables(model: torch.nn.Module,
                        variables: Mapping[str, Any]) -> None:
    """Copy ``{"params", "batch_stats"}`` into ``model`` in place."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    flat: Dict[str, np.ndarray] = {}
    for col in ("params", "batch_stats"):
        for key, val in flatten_tree(variables.get(col, {})).items():
            if key in flat:
                raise KeyError(f"{key!r} appears in params and batch_stats")
            flat[key] = val
    state = model.state_dict()
    missing = sorted(set(state) - set(flat))
    extra = sorted(set(flat) - set(state))
    if missing or extra:
        raise KeyError(f"weight bridge mismatch: missing {missing}, "
                       f"extra {extra}")
    with torch.no_grad():
        for key, dst in state.items():
            src = flat[key]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)} from the "
                                 f"JAX tree, {tuple(dst.shape)} in the port")
            dst.copy_(torch.as_tensor(np.array(src), dtype=dst.dtype))


def _nest(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    """{"a.b.c": leaf} -> nested dicts."""
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        node = out
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    return out


def to_flax_variables(model: torch.nn.Module) -> Dict[str, Dict[str, Any]]:
    """``{"params", "batch_stats"}`` of ``model`` as nested dicts of numpy
    arrays, the inverse of :func:`load_flax_variables`: parameters go to
    ``params``, persistent buffers (the BatchNorm statistics) to
    ``batch_stats``."""
    state = model.state_dict()
    params = {name for name, _ in model.named_parameters()}
    flat = {col: {} for col in ("params", "batch_stats")}
    for key, val in state.items():
        col = "params" if key in params else "batch_stats"
        flat[col][key] = val.detach().cpu().numpy().copy()
    return {col: _nest(tree) for col, tree in flat.items()}
