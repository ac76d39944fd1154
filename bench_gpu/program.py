"""The system under test: the port's model and engine, built from a
configuration file as the port's runners build them.

This is the one module of the benchmark that imports the port
(``dstdgcn_tpu_torch``).  It builds the model from the configuration's
``model`` block (with ``auto_batch_hint`` pinned to ``train_batch_size``
where a knob is "auto", as ``runner/base.py`` does) and the engine from its
``engine`` block, compiles only the kernel libraries the cell's path loads
(one ``nvcc`` each, in parallel; a library built before is found by its
hash in the port's build directory), and gives the few program hooks the
harness reads: the kernel launch counters and the DSTD-GC op modules.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

import dstdgcn_tpu_torch
from dstdgcn_tpu_torch.engine import PredictionEngine
from dstdgcn_tpu_torch.kernels import build as kernel_build
from dstdgcn_tpu_torch.kernels import fused
from dstdgcn_tpu_torch.models import get_model

#: the top-level name of the port's package
PACKAGE = dstdgcn_tpu_torch.__name__


def build_libraries(names: Iterable[str]) -> dict:
    """Compile the kernel libraries ``names`` that the port has and that
    are not built yet; returns seconds per library (0.0 when built)."""
    names = [n for n in names if n in kernel_build.SOURCES]
    return kernel_build.build_all(names) if names else {}


def make_engine(config: dict, device) -> PredictionEngine:
    """The model and engine of ``config`` on ``device``."""
    model_cfg = {k: v for k, v in dict(config["model"]).items()
                 if k not in ("name", "load", "ckpt")}
    name = config["model"]["name"]
    opts = {name: dict(config["model"][name]), **{
        k: v for k, v in model_cfg.items() if k != name}}
    knobs = list(opts[name].values()) + list(opts.values())
    if any(isinstance(v, str) and v == "auto" for v in knobs):
        opts.setdefault("auto_batch_hint", int(config["train_batch_size"]))
    model = get_model(name, **opts)
    return PredictionEngine(dict(config["engine"]), model, None,
                            device=device)


def launch_counts() -> dict:
    return fused.launch_counts()


def launch_variant(name: str) -> str:
    """The precision of the DSTD-GC kernel ``name`` in
    :func:`launch_counts`: the port names its bf16 variants
    ``<name>_bf16``."""
    return "bfloat16" if name.endswith("_bf16") else "float32"


def reset_launch_counts() -> None:
    fused.reset_launch_counts()


def op_modules(model: torch.nn.Module) -> List[torch.nn.Module]:
    """The model's DSTD-GC op modules (one spatial or temporal op each)."""
    return [m for m in model.modules() if type(m).__name__ == "DSTDGC"]
