"""Native (C++) reader of comma-separated float matrices, bound with ctypes.

Counterpart of ``dstdgcn_tpu/data/native.py::fast_read_csv``.  The source
is ``csrc/fast_csv.cpp``; it is compiled with ``g++ -O2 -shared -fPIC`` at
first use into ``dstdgcn_tpu_torch/build/`` (listed in ``.gitignore``),
named by a hash of the source and flags so a changed source is rebuilt, and
loaded with ``ctypes``.  A failed build raises.  :func:`fast_read_csv`
returns None for a ragged or empty file, which its caller then reads with
``np.loadtxt``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["fast_read_csv", "library"]

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "fast_csv.cpp"
BUILD_DIR = PKG_DIR / "build"
FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastcsv-{h.hexdigest()[:16]}.so"


def _build(path: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native CSV reader is built "
                           "from csrc/fast_csv.cpp at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE.name} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)


def library() -> ctypes.CDLL:
    """The loaded reader library, built first if missing."""
    global _lib
    with _lock:
        if _lib is None:
            path = _lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.parse_csv.restype = ctypes.c_long
            lib.parse_csv.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_long, ctypes.POINTER(ctypes.c_long),
                ctypes.POINTER(ctypes.c_long)]
            _lib = lib
        return _lib


def fast_read_csv(path: str) -> Optional[np.ndarray]:
    """(rows, cols) float32 matrix of a comma-separated file; None if the
    file is ragged, empty or unreadable."""
    lib = library()
    rows = ctypes.c_long()
    cols = ctypes.c_long()
    name = os.fsencode(path)
    count = lib.parse_csv(name, None, 0, ctypes.byref(rows),
                          ctypes.byref(cols))
    if count <= 0 or rows.value * cols.value != count:
        return None
    out = np.empty(count, np.float32)
    got = lib.parse_csv(
        name, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), count,
        ctypes.byref(rows), ctypes.byref(cols))
    if got != count:
        return None
    return out.reshape(rows.value, cols.value)
