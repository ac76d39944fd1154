"""CLI entry point: run a skeleton-prediction experiment with the port.

    python -m dstdgcn_tpu_torch.main --run_dir DIR --config CONFIG.yaml \
        [--device cuda|cpu]

Runs on ``cuda`` unless ``--device cpu`` is given, and raises when CUDA is
asked for but absent.  A config's ``device`` key is ignored.  A
multi-process launch (``DSTDGCN_*`` variables or the config's
``parallel.distributed`` block, :mod:`.parallel.distributed`) joins its
process group first, before any device query; each rank then runs on its
own device (``cuda:<rank mod device_count>``; ranks share a card under the
``gloo`` backend).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch.distributed as dist

from .parallel import distributed
from .runner import get_runner
from .utils.config import EasyDict, get_config, resolve
from .utils.device import resolve_device
from .utils.logging import setup_logger

__all__ = ["run", "main"]


def run(opts, device: str = "cuda", run_dir: Optional[str] = None):
    """Build the runner of ``opts`` (a config dict or :class:`EasyDict`,
    ``!!python`` values allowed) and run its mode on ``device`` (this
    rank's device under a process group, which it joins first); returns
    the runner (its ``engine`` holds the model) and the mode's result."""
    if not isinstance(opts, EasyDict):
        opts = EasyDict(resolve(opts))
    rank, world = distributed.initialize(
        (opts.get("parallel") or {}).get("distributed"), device=device)
    dev = resolve_device(distributed.device_of(device))
    if run_dir is not None:
        opts["save"]["path"]["base"] = run_dir
    base = opts["save"]["path"]["base"]
    os.makedirs(base, exist_ok=True)
    logger = setup_logger("prediction", base, rank)
    logger.info(f"Pid: {os.getpid()} device: {dev} rank: {rank} of {world}")
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
    try:
        return run(opts, args.device, run_dir=args.run_dir)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
