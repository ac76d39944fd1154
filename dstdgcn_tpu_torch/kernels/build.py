"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) and loaded with
``ctypes``.  Libraries are built at first use into ``dstdgcn_tpu_torch/build/``
(listed in ``.gitignore``), named by a hash of the sources and flags so a
changed source is rebuilt.  :func:`build_all` compiles every missing library
at once, one ``nvcc`` process per source running in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "SIGNATURES", "build_all", "library", "build_log"]

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

#: library name -> kernel source in csrc/
SOURCES = {
    "dstd_spatial": "dstd_spatial.cu",
    "dstd_temporal": "dstd_temporal.cu",
    "dstd_spatial_bwd": "dstd_spatial_bwd.cu",
    "dstd_temporal_bwd": "dstd_temporal_bwd.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_SIZE = ctypes.c_longlong
#: C functions of each library, suffix -> (argtypes, restype)
_FORWARD = {
    # (x, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm, out,
    #  N, T, V, Ci, Co, K, R, agg_left, tile, device, stream)
    "f32": ([_PTR] * 12 + [_INT] * 10 + [_PTR], ctypes.c_int),
    # (T, V, Ci, Co, K, R, tile)
    "smem_bytes": ([_INT] * 7, _SIZE),
}
_BACKWARD = {
    # (x, g, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm, dx, dbase,
    #  dalpha, dwf, dbf, dwm1, dbm1, dwm2, dbm2, dwrm, dbrm, scratch,
    #  N, T, V, Ci, Co, K, R, agg_left, tile, device, stream)
    "f32": ([_PTR] * 24 + [_INT] * 10 + [_PTR], ctypes.c_int),
    "smem_bytes": ([_INT] * 7, _SIZE),
    # (N, T, V, Ci, Co, K, R, tile)
    "scratch_floats": ([_INT] * 8, _SIZE),
}
SIGNATURES = {"dstd_spatial": _FORWARD, "dstd_temporal": _FORWARD,
              "dstd_spatial_bwd": _BACKWARD, "dstd_temporal_bwd": _BACKWARD}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the CUDA kernels are built from csrc/ at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC_DIR / SOURCES[name]] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


class _Libraries:
    """Loaded kernel libraries and their build logs (one per process)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.loaded: Dict[str, ctypes.CDLL] = {}
        self.logs: Dict[str, str] = {}

    def build(self, names: Iterable[str]) -> Dict[str, float]:
        """Compile every missing library in ``names`` in parallel; returns
        seconds per compiled library (0.0 when it was already built)."""
        names = list(names)
        todo = [n for n in names if not _lib_path(n).exists()]
        secs = {n: 0.0 for n in names}
        if not todo:
            return secs
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            tmp = _lib_path(name).with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", str(tmp),
                   str(CSRC_DIR / SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, time.perf_counter())
        failed = []
        for name, (proc, tmp, t0) in procs.items():
            log, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            self.logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name} (exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, _lib_path(name))
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return secs

    def get(self, name: str) -> ctypes.CDLL:
        with self.lock:
            lib = self.loaded.get(name)
            if lib is not None:
                return lib
            self.build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            for suffix, (argtypes, restype) in SIGNATURES[name].items():
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = restype
            lib.dstd_error_string.argtypes = [ctypes.c_int]
            lib.dstd_error_string.restype = ctypes.c_char_p
            self.loaded[name] = lib
            return lib


_LIBS = _Libraries()


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every kernel library (or ``names``), one nvcc per source in
    parallel; returns the compile seconds of each."""
    with _LIBS.lock:
        return _LIBS.build(SOURCES if names is None else names)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    return _LIBS.get(name)


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) for a
    library compiled by this process, else an empty string."""
    return _LIBS.logs.get(name, "")
