"""The port's checkpoints.

A checkpoint holds the model's ``state_dict``, the optimizer's
``state_dict``, the dropout generator's state and the ``{lr, err, epoch}``
payload, written with ``torch.save`` to ``path + ".tmp"`` and published with
``os.replace`` (no torn file on failure), and read with
``torch.load(weights_only=True)``.  The JAX package's msgpack checkpoints
(an 8-byte length, a JSON payload, a flax blob) are recognised and refused.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import torch

__all__ = ["save_checkpoint", "load_checkpoint"]

_ZIP_MAGIC = b"PK\x03\x04"   # torch.save writes a zip archive


def save_checkpoint(path: str, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer,
                    generator: torch.Generator,
                    payload: Dict[str, Any]) -> None:
    blob = {"model": model.state_dict(),
            "optimizer": optimizer.state_dict(),
            "generator": generator.get_state(),
            "payload": dict(payload)}
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def _is_jax_checkpoint(head: bytes, size: int) -> bool:
    if len(head) < 8:
        return False
    n = int.from_bytes(head[:8], "little")
    if not 0 < n <= min(size - 8, len(head) - 8):
        return False
    try:
        meta = json.loads(head[8:8 + n].decode())
    except (UnicodeDecodeError, ValueError):
        return False
    return isinstance(meta, dict)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """``{"model", "optimizer", "generator", "payload"}`` of a checkpoint
    written by :func:`save_checkpoint`, tensors on the CPU."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(1 << 16)
    if head[:4] != _ZIP_MAGIC:
        if _is_jax_checkpoint(head, size):
            raise NotImplementedError(
                f"{path} is a checkpoint of the JAX package (msgpack); "
                "reading it is not ported yet (ROADMAP Queue 1 item 6)")
        raise ValueError(f"{path} is not a checkpoint of the port")
    return torch.load(path, map_location="cpu", weights_only=True)
