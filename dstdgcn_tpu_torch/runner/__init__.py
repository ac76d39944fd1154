"""Runner factory."""

from .action_runner import ActionRunner, CMURunner, H36MRunner
from .base import BaseRunner
from .forecast_runner import ForecastRunner
from .simple_runner import PW3DRunner, SimpleRunner, SyntheticRunner

_RUNNERS = {
    "h36m": H36MRunner,
    "cmu": CMURunner,
    "3dpw": PW3DRunner,
    "synthetic": SyntheticRunner,
    "forecast": ForecastRunner,
}


def get_runner(name: str, config, device="cuda"):
    if name not in _RUNNERS:
        raise ValueError(f"unknown runner {name!r}")
    return _RUNNERS[name](config, device=device)


__all__ = ["get_runner", "BaseRunner", "ActionRunner", "ForecastRunner",
           "H36MRunner", "CMURunner", "PW3DRunner", "SimpleRunner",
           "SyntheticRunner"]
