"""Build and bind the hand-written CUDA kernels of the port.

Every ``*.cu`` in this directory is compiled by its own ``nvcc`` process
(all started together) and the objects are linked into one shared library
with a plain C interface at first use, into ``sres_tpu_torch/_build/``
(keyed by a hash of every source, header and flag), and bound with
``ctypes``. No PyTorch header is compiled, so a build takes seconds.
Pointers are passed as ``data_ptr()`` integers and the stream as
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

SOURCE_DIR = Path(__file__).parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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
    f = ctypes.c_float
    lib.sres_wino_conv.argtypes = [vp] * 5 + [i] * 6 + [f, i, vp]
    lib.sres_wino_chain.restype = i
    lib.sres_wino_chain.argtypes = [vp] * 5 + [i] * 8 + [vp]
    lib.sres_ca_skip.restype = i
    lib.sres_ca_skip.argtypes = [vp] * 8 + [i] * 5 + [vp]
    for name in ("sres_ca_skip_cluster", "sres_ca_skip_scratch"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [i] * 4
    lib.sres_wino_bwd_scratch.restype = i
    lib.sres_wino_bwd_scratch.argtypes = [i] * 5
    lib.sres_wino_conv_bwd.restype = i
    lib.sres_wino_conv_bwd.argtypes = [vp] * 10 + [i] * 8 + [vp]
    lib.sres_ca_skip_bwd.restype = i
    lib.sres_ca_skip_bwd.argtypes = [vp] * 13 + [i] * 5 + [vp]
    for name in ("sres_ca_skip_bwd_scratch", "sres_fg_ca_bwd_scratch"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [i] * 4
    for name in ("sres_wattn_tile", "sres_wattn_max_tokens", "sres_wattn_bwd_proj_rows"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = []
    lib.sres_wattn_rows.restype = i
    lib.sres_wattn_rows.argtypes = [i]
    lib.sres_wattn_fwd.restype = i
    lib.sres_wattn_fwd.argtypes = [vp] * 9 + [i] * 4 + [f] + [i] * 3 + [vp]
    lib.sres_wattn_bwd.restype = i
    lib.sres_wattn_bwd.argtypes = [vp] * 14 + [i] * 4 + [f] + [i] * 4 + [vp]
    lib.sres_fg_tiles.restype = i
    lib.sres_fg_tiles.argtypes = [i, i, i]
    lib.sres_fg_conv.restype = i
    lib.sres_fg_conv.argtypes = [vp] * 10 + [i] * 7 + [vp]
    lib.sres_fg_ca.restype = i
    lib.sres_fg_ca.argtypes = [vp] * 3 + [i] + [vp] * 7 + [i] * 5 + [vp]
    lib.sres_fg_wgrad_scratch.restype = i
    lib.sres_fg_wgrad_scratch.argtypes = [i] * 5
    lib.sres_fg_wgrad.restype = i
    lib.sres_fg_wgrad.argtypes = [vp] * 5 + [i] + [vp] * 3 + [i] * 5 + [vp]
    lib.sres_fg_ca_bwd.restype = i
    lib.sres_fg_ca_bwd.argtypes = [vp] * 12 + [i] * 5 + [vp]
    ll = ctypes.c_longlong
    lib.sres_q8_quantize.restype = i
    lib.sres_q8_quantize.argtypes = [vp, i] + [ll] * 5 + [i] * 5 + [vp, i] + [vp] * 3 + [i, vp]
    lib.sres_s8_conv_fprop.restype = i
    lib.sres_s8_conv_fprop.argtypes = [vp] * 6 + [i] * 8 + [vp]
    lib.sres_s8_conv_wgrad.restype = i
    lib.sres_s8_conv_wgrad.argtypes = [vp] * 5 + [i] * 8 + [vp]
    return lib


def sources():
    """The kernel sources (compiled) and headers (hashed), sorted."""
    return (sorted(SOURCE_DIR.glob("*.cu")),
            sorted(SOURCE_DIR.glob("*.cuh")))


def load() -> ctypes.CDLL:
    """The kernel library, built on first call; raises if the build fails."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    flags = ARCH_FLAGS + NVCC_FLAGS
    srcs, hdrs = sources()
    digest = hashlib.sha1(" ".join(flags).encode())
    for f in srcs + hdrs:
        digest.update(f.name.encode() + f.read_bytes())
    so = BUILD_DIR / f"libsres_wino_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        nvcc = nvcc_path()
        t0 = time.perf_counter()
        objs = [so.with_name(f"{f.stem}.{tag}.o") for f in srcs]
        procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(o), str(f)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for f, o in zip(srcs, objs)]
        outs = [p.communicate()[0] for p in procs]
        build_log = "".join(outs)
        for f, p, out in zip(srcs, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {f.name} ({p.returncode}):"
                                   f"\n{out}")
        tmp = so.with_name(f"{so.name}.{tag}")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log += proc.stdout + proc.stderr
        for o in objs:
            o.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{build_log}")
        os.replace(tmp, so)
    _lib = _bind(ctypes.CDLL(str(so)))
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err:
        msg = load().sres_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
