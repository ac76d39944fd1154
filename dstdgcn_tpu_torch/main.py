"""CLI entry point: run a skeleton-prediction experiment with the port.

    python -m dstdgcn_tpu_torch.main --run_dir DIR --config CONFIG.yaml \
        [--device cuda|cpu]

Runs on ``cuda`` unless ``--device cpu`` is given, and raises when CUDA is
asked for but absent.  A config's ``device`` key is ignored.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from .runner import get_runner
from .utils.config import EasyDict, get_config, resolve
from .utils.device import resolve_device
from .utils.logging import setup_logger

__all__ = ["run", "main"]


def run(opts, device: str = "cuda", run_dir: Optional[str] = None):
    """Build the runner of ``opts`` (a config dict or :class:`EasyDict`,
    ``!!python`` values allowed) and run its mode on ``device``; returns the
    runner (its ``engine`` holds the model) and the mode's result."""
    dev = resolve_device(device)
    if not isinstance(opts, EasyDict):
        opts = EasyDict(resolve(opts))
    if run_dir is not None:
        opts["save"]["path"]["base"] = run_dir
    base = opts["save"]["path"]["base"]
    os.makedirs(base, exist_ok=True)
    logger = setup_logger("prediction", base)
    logger.info(f"Pid: {os.getpid()} device: {dev}")
    opts["logger"] = logger
    runner = get_runner(opts["runner"], opts, device=dev)
    return runner, runner.run()


def main(argv: Optional[Sequence[str]] = None):
    parser = argparse.ArgumentParser(
        description="Running a skeleton prediction network (PyTorch/CUDA).")
    parser.add_argument("--exp_name", default="test_model", type=str,
                        help="experiment name")
    parser.add_argument("--run_dir", default="run/", type=str,
                        help="result dir")
    parser.add_argument("--config", default="configs/config.yaml",
                        help="config file")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="device to run on (default cuda)")
    args = parser.parse_args(argv)
    opts = get_config(args.config)
    return run(opts, args.device, run_dir=args.run_dir)


if __name__ == "__main__":
    main()
