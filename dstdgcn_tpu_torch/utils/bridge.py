"""Weight bridge: JAX package variables -> the port's ``DSTDGCN``.

The JAX model's variables are ``{"params": tree, "batch_stats": tree}``;
hand them over as nested dicts of numpy arrays (for example
``jax.tree.map(np.asarray, variables)``).  The port names its submodules,
parameters and buffers after the flax tree (``encoder_0.block.spatial.wf``,
``encoder_bn_0.mean``), so loading is a flatten-and-copy that fails on any
missing, extra or mis-shaped key.  No JAX import is needed.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["flatten_tree", "load_flax_variables"]


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
