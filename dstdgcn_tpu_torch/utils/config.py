"""YAML experiment configuration.

Same schema as ``dstdgcn_tpu/utils/config.py``: attribute/key hybrid access
and ``!!python``-prefixed expression values evaluated in a restricted
namespace (numpy + arithmetic).  ``yaml`` is imported inside
:func:`get_config`, so the rest of the port runs where PyYAML is absent
(configs can be plain dicts).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

__all__ = ["EasyDict", "get_config", "resolve"]


class EasyDict:
    """Dict with attribute access."""

    def __init__(self, opt: Dict[str, Any]):
        object.__setattr__(self, "opt", opt)

    def __getattr__(self, name):
        opt = object.__getattribute__(self, "opt")
        if name in opt:
            return opt[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        self.opt[name] = value

    def __getitem__(self, name):
        return self.opt[name]

    def __setitem__(self, name, value):
        self.opt[name] = value

    def __contains__(self, item):
        return item in self.opt

    def __repr__(self):
        return repr(self.opt)

    def get(self, name, default=None):
        return self.opt.get(name, default)

    def keys(self):
        return self.opt.keys()

    def values(self):
        return self.opt.values()

    def items(self):
        return self.opt.items()


_EXPR_GLOBALS = {"__builtins__": {}, "np": np, "list": list, "range": range,
                 "len": len, "min": min, "max": max, "sum": sum,
                 "sorted": sorted, "abs": abs, "int": int, "float": float}


def resolve(config):
    """Evaluate every ``!!python <expr>`` string value, recursively."""
    if isinstance(config, dict):
        return {k: resolve(v) for k, v in config.items()}
    if isinstance(config, list):
        return [resolve(v) for v in config]
    if isinstance(config, str) and config.startswith("!!python"):
        return eval(config[len("!!python"):], dict(_EXPR_GLOBALS))
    return config


def get_config(config_file: str) -> EasyDict:
    import yaml
    with open(config_file) as f:
        return EasyDict(resolve(yaml.safe_load(f)))
