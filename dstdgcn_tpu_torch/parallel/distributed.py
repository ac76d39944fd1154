"""Multi-process launch: ``torch.distributed`` initialization and process
info.

Counterpart of ``dstdgcn_tpu/parallel/distributed.py``.  Each process calls
:func:`initialize` before it touches a device; it joins the process group,
and a rank's device is ``cuda:<rank mod device_count>`` (:func:`device_of`).
One process a GPU is NCCL's rule; two ranks on one card need the ``gloo``
backend, whose CUDA tensors take ``all_reduce``, ``broadcast`` and
``barrier``, all that data-parallel training asks.

Launch, one process a rank, e.g. two ranks of one host::

    DSTDGCN_COORDINATOR=localhost:29500 DSTDGCN_NUM_PROCESSES=2 \\
    DSTDGCN_PROCESS_ID=$RANK python -m dstdgcn_tpu_torch.main \\
        --config ... --run_dir ...

or through the config block (the environment overrides it per process)::

    parallel:
      data: auto
      distributed:
        coordinator: host0:1234   # or a URL: tcp://..., file://...
        num_processes: 2
        process_id: 0             # usually from the environment
        backend: gloo             # default: nccl on cuda, gloo on cpu

``coordinator: auto`` reads torch's own launcher variables (``torchrun``:
``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) and is a single process without
them, as the JAX package is off a TPU pod.

``make_global_batch`` has no counterpart: a rank keeps its shard of each
global batch (the loader's split by process, ``data/loader.py``), and the
engine reduces what GSPMD would compute on the global array (gradients,
losses, BatchNorm statistics, evaluation sums).
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["initialize", "process_info", "device_of", "TIMEOUT"]

#: the process group's timeout: a collective whose peers do not come within
#: it raises instead of waiting for ever
TIMEOUT = datetime.timedelta(seconds=300)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(dist_cfg: Optional[Dict[str, Any]] = None, logger=None,
               device: str | torch.device = "cuda") -> Tuple[int, int]:
    """Join the process group from the environment and the config block;
    idempotent.

    Per field, the ``DSTDGCN_COORDINATOR`` / ``DSTDGCN_NUM_PROCESSES`` /
    ``DSTDGCN_PROCESS_ID`` / ``DSTDGCN_BACKEND`` variables FIRST, then the
    block (``coordinator``, ``num_processes``, ``process_id``,
    ``backend``).  No block and no variables: a single process, nothing
    done, ``(0, 1)``.  The backend defaults to ``nccl`` on ``device`` cuda
    and ``gloo`` on cpu; it is never changed because a call failed.  A
    coordinator ``host:port`` rendezvouses over ``tcp://``; a URL
    (``tcp://``, ``file://``) is used as it is.

    Returns ``(rank, world_size)``.
    """
    cfg = dict(dist_cfg or {})
    coord = os.environ.get("DSTDGCN_COORDINATOR") or cfg.get("coordinator")
    nproc = _env_int("DSTDGCN_NUM_PROCESSES")
    if nproc is None and cfg.get("num_processes") is not None:
        nproc = int(cfg["num_processes"])
    pid = _env_int("DSTDGCN_PROCESS_ID")
    if pid is None and cfg.get("process_id") is not None:
        pid = int(cfg["process_id"])
    dev = torch.device(device)
    backend = (os.environ.get("DSTDGCN_BACKEND") or cfg.get("backend")
               or ("nccl" if dev.type == "cuda" else "gloo"))

    if not cfg and coord is None and nproc is None:
        return 0, 1                       # single-process launch
    if not dist.is_initialized():
        if coord in (None, "auto") and nproc is None and pid is None:
            if not all(os.environ.get(k) for k in
                       ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
                if logger is not None:
                    logger.info("coordinator: auto and no launcher "
                                "variables: a single process")
                return 0, 1
            dist.init_process_group(backend, init_method="env://",
                                    timeout=TIMEOUT)
        else:
            if coord in (None, "auto") or nproc is None or pid is None:
                raise ValueError(
                    "a multi-process launch needs a coordinator, "
                    "num_processes and process_id (DSTDGCN_COORDINATOR, "
                    "DSTDGCN_NUM_PROCESSES, DSTDGCN_PROCESS_ID or the "
                    f"parallel.distributed block): got {coord!r}, {nproc!r}, "
                    f"{pid!r}")
            url = coord if "://" in coord else f"tcp://{coord}"
            dist.init_process_group(backend, init_method=url,
                                    world_size=nproc, rank=pid,
                                    timeout=TIMEOUT)
    info = process_info()
    if dev.type == "cuda" and dev.index is None \
            and torch.cuda.is_available():
        torch.cuda.set_device(device_of(dev))
    if logger is not None:
        logger.info(f"torch.distributed: rank {info[0]} of {info[1]}, "
                    f"backend {dist.get_backend()}, device "
                    f"{device_of(dev)}")
    return info


def process_info() -> Tuple[int, int]:
    """``(rank, world_size)`` of this launch; ``(0, 1)`` without a process
    group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def device_of(device: str | torch.device = "cuda") -> torch.device:
    """The device this rank runs on: ``cuda:<rank mod device_count>`` for
    ``cuda`` under a process group; ``device`` as given otherwise (an index
    given is kept)."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None \
            or not dist.is_initialized() or not torch.cuda.is_available():
        return dev
    return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
