"""Build and bind the hand-written CUDA kernels of the port.

The sources in this directory are compiled by ``nvcc`` into one shared
library with a plain C interface at first use, into
``sres_tpu_torch/_build/`` (keyed by a hash of the source and the flags),
and bound with ``ctypes``. No PyTorch header is compiled, so a build takes
seconds. Pointers are passed as ``data_ptr()`` integers and the stream as
``torch.cuda.current_stream().cuda_stream``.

Nothing here runs at import time, so every module of the package imports
on a machine without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).with_name("winograd.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of the last nvcc run
build_log: str = ""                     # nvcc/ptxas output of that run


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises if absent."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME, /usr/local/cuda "
                       "and PATH): the CUDA kernels cannot be built")


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.sres_channels.restype = i
    lib.sres_channels.argtypes = []
    lib.sres_max_hidden.restype = i
    lib.sres_max_hidden.argtypes = []
    lib.sres_error_string.restype = ctypes.c_char_p
    lib.sres_error_string.argtypes = [i]
    lib.sres_wino_conv.restype = i
    lib.sres_wino_conv.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, vp]
    lib.sres_ca_skip.restype = i
    lib.sres_ca_skip.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp,
                                 i, i, i, i, i, i, i, vp]
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first call; raises if the build fails."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    flags = ARCH_FLAGS + NVCC_FLAGS
    tag = hashlib.sha1(SOURCE.read_bytes() + " ".join(flags).encode()
                       ).hexdigest()[:16]
    so = BUILD_DIR / f"libsres_wino_{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags, "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{build_log}")
        os.replace(tmp, so)
    _lib = _bind(ctypes.CDLL(str(so)))
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err:
        msg = load().sres_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
