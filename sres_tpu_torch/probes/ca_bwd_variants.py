"""Where the time of the two channel-attention backwards goes.

    python -m sres_tpu_torch.probes.ca_bwd_variants

Builds variants of ``ops/cuda/winograd_bwd.cu`` (``ca_skip_bwd``) and
``ops/cuda/fused_group.cu`` (``fgroup_ca_bwd``), with edited copies of
``ca_common.cuh``, into ``_build/probe_ca_bwd/`` (one nvcc each, all at once)
and times both wrappers on each, in device time at (72, 64, 48, 48) bf16
(``ca_skip_bwd``'s da in f32), hidden 32:

- ``base``: the sources as they are;
- ``stream``: the stream of phase (1) alone, each block returning before
  the first grid barrier;
- ``barrier1``: the stream and the first grid barrier;
- ``no_wgrad``: phases (1) and (2), no weight gradient;
- ``no_mlp``: the barrier, the count and the weight gradient, no MLP;
- ``b<B>x<K>``: the shipped code with B vectors a thread in flight and K
  blocks an SM (both trunks' constants set alike).

The text edits must match the source: a change there needs them updated.
Needs a CUDA card and nvcc; prints the card's name and power limit, then
one JSON line per variant, with each wrapper's byte bound.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import numpy as np

SHAPE = (72, 64, 48, 48)
SLEEP_CYCLES = 50_000_000      # as ca_ab.py: the host queues the calls meanwhile
HBM_BYTES_S = 3.35e12

BARRIER1 = "  cooperative_groups::this_grid().sync();            // every partial row written\n"
DONE = "    if (tid == 0) atomicAdd(done, 1u);\n  }\n"
MLP_LOOP = "  for (int im = im0; im < nimg; im += imstep) {\n"
WINO_K = "constexpr int kCaBwdBatch = 4, kCaBwdBlocks = 2;"
FG_K = "constexpr int kFgCaBwdBatch = 4, kFgCaBwdBlocks = 3;"


def _consts(batch: int, blocks: int):
    return {"winograd_bwd.cu": [(WINO_K, f"constexpr int kCaBwdBatch = {batch}, "
                                         f"kCaBwdBlocks = {blocks};")],
            "fused_group.cu": [(FG_K, f"constexpr int kFgCaBwdBatch = {batch}, "
                                      f"kFgCaBwdBlocks = {blocks};")]}


VARIANTS = {
    "base": {},
    "stream": {"ca_common.cuh": [(BARRIER1, "  if (nimg > 0) return;\n" + BARRIER1)]},
    "barrier1": {"ca_common.cuh": [(BARRIER1, BARRIER1 + "  if (nimg > 0) return;\n")]},
    "no_wgrad": {"ca_common.cuh": [(DONE, DONE + "  if (nimg > 0) return;\n")]},
    "no_mlp": {"ca_common.cuh": [(MLP_LOOP, MLP_LOOP.replace("im < nimg;", "im < 0;"))]},
    **{f"b{b}x{k}": _consts(b, k) for b, k in ((4, 3), (4, 2), (6, 2), (3, 3))},
}
SOURCES = ("winograd_bwd.cu", "fused_group.cu")
HEADERS = ("ca_common.cuh", "wino_common.cuh")


def edited(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"probe edit does not match the source once: {old[:70]!r}")
        src = src.replace(old, new)
    return src


class _Mix:
    """The variant's channel-attention backward entries, the built library's
    others."""

    def __init__(self, main, var):
        self.main, self.var = main, var

    def __getattr__(self, name):
        var = name.startswith(("sres_ca_skip_bwd", "sres_fg_ca_bwd"))
        return getattr(self.var if var else self.main, name)


def _bind(paths):
    libs = [ctypes.CDLL(str(p)) for p in paths]
    vp, i = ctypes.c_void_p, ctypes.c_int
    entries = {"sres_ca_skip_bwd_scratch": [i] * 4, "sres_fg_ca_bwd_scratch": [i] * 4,
               "sres_ca_skip_bwd": [vp] * 13 + [i] * 5 + [vp],
               "sres_fg_ca_bwd": [vp] * 12 + [i] * 5 + [vp]}

    class Lib:
        pass

    lib = Lib()
    for name, args in entries.items():
        fn = next(getattr(l, name) for l in libs if hasattr(l, name))
        fn.restype, fn.argtypes = i, args
        setattr(lib, name, fn)
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from sres_tpu_torch.ops import cuda
    from sres_tpu_torch.ops import fused_group as fg
    from sres_tpu_torch.ops import winograd_conv as twc
    main_lib = cuda.load()
    out = cuda.BUILD_DIR / "probe_ca_bwd"
    procs = {}
    for name, edits in VARIANTS.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f in SOURCES + HEADERS:
            (d / f).write_text(edited((cuda.SOURCE_DIR / f).read_text(), edits.get(f, [])))
        procs[name] = [subprocess.Popen(
            [cuda.nvcc_path(), *cuda.ARCH_FLAGS, *cuda.NVCC_FLAGS, "-shared", "-o",
             str(d / f"{f}.so"), str(d / f)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for f in SOURCES]
    libs = {}
    for name, ps in procs.items():
        for p in ps:
            log = p.communicate()[0]
            if p.returncode:
                raise SystemExit(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        libs[name] = _Mix(main_lib, _bind(out / name / f"{f}.so" for f in SOURCES))

    dev, cl = torch.device("cuda"), torch.channels_last
    rng = np.random.default_rng(14)
    f32 = lambda *s, sc=1.0, dc=0.0: torch.from_numpy(
        (rng.normal(size=s) * sc + dc).astype(np.float32)).to(dev)
    ca = [f32(32, 64, sc=0.1), f32(32, sc=0.1), f32(64, 32, sc=0.1), f32(64, sc=0.1)]
    da = f32(*SHAPE).contiguous(memory_format=cl)
    c2 = f32(*SHAPE, dc=0.3).bfloat16().contiguous(memory_format=cl)
    g = f32(*SHAPE).bfloat16().contiguous(memory_format=cl)
    gate = f32(SHAPE[0], 64).sigmoid()
    n = da.numel()
    calls = {"ca_skip_bwd": (lambda: twc.ca_skip_bwd(da, c2, *ca), (4 + 2) * n),
             "fgroup_ca_bwd": (lambda: fg.fgroup_ca_bwd(g, c2, gate, *ca), (2 + 2) * n)}

    def ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    bound = {k: 1e3 * b / HBM_BYTES_S for k, (_, b) in calls.items()}
    for name, lib in libs.items():
        cuda._lib = lib
        twc._SCRATCH.clear()            # the variants' grids differ
        res = {k: [ms(f) for _ in range(2)] for k, (f, _) in calls.items()}
        print(json.dumps(dict(variant=name, shape=SHAPE, device_ms=res, bound_ms=bound)),
              flush=True)
    cuda._lib = main_lib
    twc._SCRATCH.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
