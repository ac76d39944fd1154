import functools
from typing import Any

import torch

from . import dstdgcn, gwnet
from .dstdgcn import DSTDGCN
from .gwnet import GWNet
from .layers import (DSTDGC, DSTDGCB, Dense, JointBatchNorm, PReLU,
                     STGCNNLayer)

__all__ = ["DSTDGCN", "GWNet", "MODELS", "get_model", "DSTDGC", "DSTDGCB",
           "Dense", "JointBatchNorm", "PReLU", "STGCNNLayer"]

#: each model name's constructor, called with the configuration's model
#: options (the model's own hyper-parameters under ``opts[name]``)
MODELS = {
    "dstdgcn": functools.partial(dstdgcn.get_model, "dstdgcn"),
    "dstdgcn_fast": functools.partial(dstdgcn.get_model, "dstdgcn_fast"),
    "gwnet": gwnet.build,
}


def get_model(name: str, **opts: Any) -> torch.nn.Module:
    """Model factory: the model ``name`` of :data:`MODELS` from the model
    options ``opts``."""
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}")
    return MODELS[name](**opts)
