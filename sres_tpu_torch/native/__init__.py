"""ctypes bindings for the native (C++/OpenMP) SWOT decoder (counterpart of
sres_tpu/native/__init__.py:1-103, with the same C interface:
``swot_build_map``, ``swot_decode``, ``bswap_f32_array``).

``swot_decode.cpp`` is compiled at first use by ``g++ -O3 -shared -fPIC
-fopenmp`` into ``sres_tpu_torch/_build/`` (git-ignored), keyed by a hash
of the source and the flags, as ``ops/cuda/__init__.py`` builds the CUDA
kernels. Unlike ``sres_tpu.native`` nothing falls back to numpy: a build
or load that fails raises with the compiler's output. The numpy
formulation stays beside it as the plain twin (``build_scatter_map_plain``,
``decode_timestep_plain``), which the tests and ``chip_smoke.py`` hold the
library to; no reader calls it. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "swot_decode.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-fopenmp"]

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last g++ run


def load() -> ctypes.CDLL:
    """The decoder library, built on first call; raises if the build or the
    load fails."""
    global _lib, build_seconds
    with _LOCK:
        if _lib is not None:
            return _lib
        digest = hashlib.sha1(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
        so = BUILD_DIR / f"libswot_decode_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"g++ not found: the SWOT decoder cannot be built "
                                   f"({' '.join(cmd)})") from e
            build_seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE.name} ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.swot_build_map.restype = i64
        lib.swot_build_map.argtypes = [vp, i64, vp]
        lib.swot_decode.restype = None
        lib.swot_decode.argtypes = [vp, vp, i64, vp]
        lib.bswap_f32_array.restype = None
        lib.bswap_f32_array.argtypes = [vp, i64, vp]
        _lib = lib
        return _lib


def build_scatter_map(mask: np.ndarray) -> np.ndarray:
    """mask (bool/uint8) → int64 map: ocean index or -1."""
    mask8 = np.ascontiguousarray(mask, np.uint8)
    out = np.empty(mask8.size, np.int64)
    load().swot_build_map(mask8.ctypes.data, mask8.size, out.ctypes.data)
    return out


def decode_timestep(be_bytes: np.ndarray, scatter_map: np.ndarray) -> np.ndarray:
    """big-endian f32 ocean values (raw uint32 view) + map → full f32 grid
    with NaN land, in one parallel pass (reference: swot/raw.py:136-140)."""
    vals = np.ascontiguousarray(be_bytes).view(np.uint32)
    smap = np.ascontiguousarray(scatter_map, np.int64)
    out = np.empty(smap.size, np.float32)
    load().swot_decode(vals.ctypes.data, smap.ctypes.data, smap.size, out.ctypes.data)
    return out


# ---------------------------------------------------------------- plain twins
def build_scatter_map_plain(mask: np.ndarray) -> np.ndarray:
    """The numpy formulation of ``build_scatter_map``."""
    mask8 = np.ascontiguousarray(mask, np.uint8).reshape(-1)
    out = np.full(mask8.size, -1, np.int64)
    idx = np.flatnonzero(mask8)
    out[idx] = np.arange(idx.size)
    return out


def decode_timestep_plain(be_bytes: np.ndarray, scatter_map: np.ndarray) -> np.ndarray:
    """The numpy formulation of ``decode_timestep``: byteswap, then scatter
    into a NaN grid (the NaN's bits are the C library's quiet NaN)."""
    host = np.ascontiguousarray(be_bytes).view(np.uint32).byteswap().view(np.float32)
    out = np.full(scatter_map.size, np.nan, np.float32)
    sel = scatter_map >= 0
    out[sel] = host[scatter_map[sel]]
    return out
