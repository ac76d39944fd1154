"""The port's checkpoints, and the JAX package's.

A checkpoint of the port holds the model's ``state_dict``, the
optimizer's ``state_dict``, the dropout generator's state and the ``{lr,
err, epoch}`` payload, written with ``torch.save`` to ``path + ".tmp"`` and
published with ``os.replace`` (no torn file on failure), and read with
``torch.load(weights_only=True)``.

A checkpoint of the JAX package (``dstdgcn_tpu/engine/checkpoint.py``) is
an 8-byte little-endian length, the JSON payload, then the engine's
``TrainState`` as flax's msgpack state dict: ``params``, ``batch_stats``,
``opt_state`` and ``dropout_key``.  :func:`msgpack_restore` decodes it
without the ``msgpack`` package (flax's ndarray and numpy-scalar extension
types); :func:`jax_optimizer_state` maps the optax
state into a torch optimizer's ``state_dict``.  The dropout key is not
read: a JAX PRNG key cannot seed torch's Philox stream, so the engine keeps
its own dropout generator, as the JAX package keeps the live key when the
saved one is of another PRNG implementation.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "msgpack_restore",
           "read_jax_checkpoint", "jax_optimizer_state"]

_ZIP_MAGIC = b"PK\x03\x04"   # torch.save writes a zip archive
#: flax's msgpack extension codes (flax/serialization.py)
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


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


# -- msgpack ----------------------------------------------------------------

class _Reader:
    """A msgpack decoder over one buffer (the subset flax writes, and the
    rest of the format's fixed types)."""

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = bytes(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
                 0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
                 0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
                 0xDC: ("array", "H"), 0xDD: ("array", "I"),
                 0xDE: ("map", "H"), 0xDF: ("map", "I")}
        if b in sized:
            kind, fmt = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "array":
                return self.array(n)
            if kind == "map":
                return self.map(n)
            return self.ext(n)
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def array(self, n: int) -> List[Any]:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack("b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray(data)
        if code == _EXT_NPSCALAR:
            return _ndarray(data)[()]
        raise ValueError(f"msgpack: unknown extension type {code}")


def _ndarray(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: msgpack of (shape, dtype name, C bytes)."""
    shape, name, buf = _Reader(data).value()
    if isinstance(name, bytes):
        name = name.decode()
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()


def msgpack_restore(blob: bytes):
    """Decode flax's ``msgpack_serialize`` bytes into nested dicts of numpy
    arrays and Python scalars, as ``flax.serialization.msgpack_restore``
    does for arrays under its 2**30-byte chunk size (an engine's state
    holds none larger)."""
    reader = _Reader(blob)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return tree


# -- the JAX package's checkpoints -----------------------------------------

def _jax_header(head: bytes, size: int):
    """The JSON payload of a JAX checkpoint's first bytes, or None."""
    if len(head) < 8:
        return None
    n = int.from_bytes(head[:8], "little")
    if not 0 < n <= min(size - 8, len(head) - 8):
        return None
    try:
        meta = json.loads(head[8:8 + n].decode())
    except (UnicodeDecodeError, ValueError):
        return None
    return meta if isinstance(meta, dict) else None


def read_jax_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(state, payload)`` of a checkpoint of the JAX package: the
    ``TrainState`` as nested dicts of numpy arrays, and the JSON payload."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        payload = json.loads(f.read(n).decode())
        blob = f.read()
    return msgpack_restore(blob), payload


def load_checkpoint(path: str) -> Dict[str, Any]:
    """``{"model", "optimizer", "generator", "payload"}`` of a checkpoint
    written by :func:`save_checkpoint`, tensors on the CPU; or, for a
    checkpoint of the JAX package, ``{"jax_state", "payload"}``
    (:func:`read_jax_checkpoint`)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(1 << 16)
    if head[:4] != _ZIP_MAGIC:
        if _jax_header(head, size) is None:
            raise ValueError(f"{path} is not a checkpoint of the port or "
                             "of the JAX package")
        state, payload = read_jax_checkpoint(path)
        return {"jax_state": state, "payload": payload}
    return torch.load(path, map_location="cpu", weights_only=True)


def _nodes(tree, keys: set, path: Tuple[str, ...] = ()):
    """(path, node) of every dict in ``tree`` whose keys are ``keys``."""
    if not isinstance(tree, dict):
        return
    if set(tree) == keys:
        yield path, tree
        return
    for k, v in tree.items():
        yield from _nodes(v, keys, path + (str(k),))


def _group_of(path: Tuple[str, ...]):
    """The ``multi_transform`` label on a state path, or None."""
    if "inner_states" in path:
        return path[path.index("inner_states") + 1]
    return None


def _leaf(tree: Mapping[str, Any], name: str) -> np.ndarray:
    node = tree
    for part in name.split("."):
        node = node[part]
    if isinstance(node, dict):
        raise KeyError(f"{name}: masked or missing in the optimizer state")
    return np.asarray(node)


def jax_optimizer_state(optimizer: torch.optim.Optimizer,
                        model: torch.nn.Module,
                        opt_state: Mapping[str, Any]) -> Dict[str, Any]:
    """``optimizer.state_dict()`` with its state taken from the optax state
    of a JAX engine that trains ``model``'s flax counterpart.

    Every form the engines build maps: ``adam`` (with L2 decay, under the
    global-norm clip, or per group under ``engine.solver``, whose
    ``multi_transform`` groups are matched by their label): ``mu``, ``nu``
    and ``count`` become ``exp_avg``, ``exp_avg_sq`` and ``step``; SGD's
    ``trace`` becomes ``momentum_buffer``; RMSprop's ``nu`` and ``trace``
    become ``square_avg`` and ``momentum_buffer``.  Raises ``ValueError``
    when the state holds another form than ``optimizer``'s."""
    from .solver import RMSprop
    names = {id(p): n for n, p in model.named_parameters()}
    adam = list(_nodes(opt_state, {"count", "mu", "nu"}))
    rms = list(_nodes(opt_state, {"nu"}))
    trace = list(_nodes(opt_state, {"trace"}))
    if isinstance(optimizer, torch.optim.Adam):
        want = {"adam": adam}
        form = bool(adam) and not rms and not trace
    elif isinstance(optimizer, torch.optim.SGD):
        want = {"trace": trace}
        form = not adam and not rms
    elif isinstance(optimizer, RMSprop):
        want = {"rms": rms, "trace": trace}
        form = bool(rms) and not adam
    else:
        raise ValueError(f"no JAX form for {type(optimizer).__name__}")
    if not form:
        raise ValueError(
            f"the checkpoint's optimizer state ({len(adam)} adam, {len(rms)} "
            f"rms, {len(trace)} trace states) is not a "
            f"{type(optimizer).__name__}'s")

    sd = optimizer.state_dict()
    state: Dict[int, Dict[str, torch.Tensor]] = {}
    for group, sd_group in zip(optimizer.param_groups, sd["param_groups"]):
        label = group.get("label")

        def node(kind):
            found = [n for path, n in want[kind] if _group_of(path) == label]
            if len(found) > 1:
                raise ValueError(f"{len(found)} {kind} states for the "
                                 f"group {label!r}")
            return found[0] if found else None

        adam_n = node("adam") if "adam" in want else None
        rms_n = node("rms") if "rms" in want else None
        trace_n = node("trace") if "trace" in want else None
        if isinstance(optimizer, torch.optim.Adam) and adam_n is None:
            raise ValueError(f"no adam state for the group {label!r}")
        if isinstance(optimizer, RMSprop) and rms_n is None:
            raise ValueError(f"no rms state for the group {label!r}")
        for p, idx in zip(group["params"], sd_group["params"]):
            name = names[id(p)]
            entry = {}

            def put(key, tree):
                entry[key] = torch.from_numpy(
                    _leaf(tree, name).astype(np.float32, copy=True))

            if adam_n is not None:
                put("exp_avg", adam_n["mu"])
                put("exp_avg_sq", adam_n["nu"])
                entry["step"] = torch.tensor(float(adam_n["count"]),
                                             dtype=torch.float32)
            if rms_n is not None:
                put("square_avg", rms_n["nu"])
            if trace_n is not None:
                put("momentum_buffer", trace_n["trace"])
            if entry:
                state[idx] = entry
    sd["state"] = state
    return sd
