"""Runner factory."""

from .base import BaseRunner
from .simple_runner import SimpleRunner, SyntheticRunner

_RUNNERS = {"synthetic": SyntheticRunner}
_LATER = ("h36m", "cmu", "3dpw")


def get_runner(name: str, config, device="cuda"):
    if name in _LATER:
        raise NotImplementedError(
            f"runner {name!r} needs the real-dataset loaders and per-action "
            "runners, which are not ported yet (ROADMAP Queue 1 item 10)")
    if name not in _RUNNERS:
        raise ValueError(f"unknown runner {name!r}")
    return _RUNNERS[name](config, device=device)


__all__ = ["get_runner", "BaseRunner", "SimpleRunner", "SyntheticRunner"]
