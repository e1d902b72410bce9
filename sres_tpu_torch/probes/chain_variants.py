"""Probe of where the conv chain's time goes (ops/cuda/winograd.cu,
``wino_chain_kernel``): builds variants of the kernel from a copy of the
source, switched by preprocessor flags, and times each against K separate
``wino_conv`` launches at chip_smoke's phase 18 shape ((72, 64, 48, 48),
m=4, K=20, bf16). Needs a CUDA card and nvcc:

    python -m sres_tpu_torch.probes.chain_variants

Variants: ``shipped`` (the library the port loads); ``ldca`` and
``plain_loads`` (activations through L1 instead of ld.global.cg);
``no_barrier`` (no grid-wide barrier between convs: wrong results, timing
only); ``one_block_per_sm``; ``stagger_5us`` and ``stagger_12us`` (half the
blocks start each conv that much later). Prints one JSON line: CUDA-event
ms per chain (two readings each, in turns), per single conv through the
chain kernel (K = 1), bit-equality with the separate launches, and the
card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys

import numpy as np
import torch

from sres_tpu_torch.ops import cuda
from sres_tpu_torch.ops import winograd_conv as wc
from sres_tpu_torch.ops.winograd import transform_weights

K, SHAPE, M = 20, (72, 64, 48, 48), 4
VARIANTS = {"ldca": ["-DLOADFN=__ldca"], "plain_loads": ["-DLOADFN=*"],
            "no_barrier": ["-DSYNCV=0"], "one_block_per_sm": ["-DGRIDMUL=1"],
            "stagger_5us": ["-DSTAGGER=5000"], "stagger_12us": ["-DSTAGGER=12000"]}
# (text in the shipped source, its switchable replacement); each switch
# defaults to the shipped behaviour
EDITS = {
    "winograd.cu": [
        ("const int grid = std::max(1, std::min(nblk, per_sm * nsm));",
         "const int grid = std::max(1, std::min(nblk, GRIDMUL * nsm));"),
        ("    if (k + 1 < nchain) grid.sync();",
         "    if (SYNCV && k + 1 < nchain) grid.sync();"),
        ("    for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x) {",
         "    if (STAGGER && blockIdx.x >= gridDim.x / 2) __nanosleep(STAGGER);\n"
         "    for (int blk = blockIdx.x; blk < nblk; blk += gridDim.x) {")],
    "wino_common.cuh": [
        ("if constexpr (kCoherent) return to_f(__ldcg(p));",
         "if constexpr (kCoherent) return to_f(LOADFN(p));")],
}
DEFAULTS = ("#ifndef GRIDMUL\n#define GRIDMUL per_sm\n#endif\n#ifndef SYNCV\n#define SYNCV 1\n"
            "#endif\n#ifndef STAGGER\n#define STAGGER 0\n#endif\n#ifndef LOADFN\n"
            "#define LOADFN __ldcg\n#endif\n")


def build_variants() -> dict:
    """Compile every variant (one nvcc each, started together) into
    sres_tpu_torch/_build/probe/ and bind its chain entry point."""
    out = cuda.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    for name, edits in EDITS.items():
        text = (cuda.SOURCE_DIR / name).read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the probe's edit point is gone: {old!r}")
            text = text.replace(old, new)
        (out / name).write_text(DEFAULTS + text if name.endswith(".cuh") else text)
    procs = {v: subprocess.Popen(
        [cuda.nvcc_path(), *cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         *flags, "-shared", "-o", str(out / f"lib_{v}.so"), str(out / "winograd.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v, flags in VARIANTS.items()}
    libs = {}
    for v, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {v}:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib_{v}.so"))
        lib.sres_wino_chain.restype = ctypes.c_int
        lib.sres_wino_chain.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        libs[v] = lib
    return libs


def time_ms(fn, iters: int = 10) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_variants: needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    libs = {"shipped": cuda.load(), **build_variants()}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    c = SHAPE[1]
    x = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32)).to(dev).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    kb = math.sqrt(6 / (9 * c))
    ws = torch.from_numpy(rng.uniform(-kb, kb, (K, c, c, 3, 3)).astype(np.float32)).to(dev)
    bv = torch.from_numpy(rng.uniform(-0.05, 0.05, (K, c)).astype(np.float32)).to(dev)
    u = transform_weights(ws, M).bfloat16()
    # the operands as the chain wrapper builds them, once
    uk = torch.stack([wc._kernel_u(u[i], M, x, c) for i in range(K)])
    bias = bv.float().contiguous()
    stream = torch.cuda.current_stream().cuda_stream

    def chain(lib, k=K):
        y, buf = torch.empty_like(x), torch.empty_like(x)
        err = lib.sres_wino_chain(x.data_ptr(), uk.data_ptr(), bias.data_ptr(),
                                  buf.data_ptr(), y.data_ptr(), k, SHAPE[0], SHAPE[2],
                                  SHAPE[3], M, 1, 1, 0, stream)
        cuda.check(err, "wino_chain probe variant")
        return y

    def separate():
        y = x
        for i in range(K):
            y = wc.wino_conv(y, u[i], bv[i], M, relu=True)
        return y

    ref = separate()
    equal = {v: bool(torch.equal(chain(lib), ref)) for v, lib in libs.items()}
    names = list(libs) + ["separate"]
    ms: dict = {}
    for name in names + names[::-1]:
        fn = separate if name == "separate" else (lambda lib=libs[name]: chain(lib))
        ms.setdefault(name, []).append(time_ms(fn))
    k1 = {v: time_ms(lambda lib=lib: chain(lib, 1), 20) for v, lib in libs.items()}
    conv1 = time_ms(lambda: wc.wino_conv(x, u[0], bv[0], M, relu=True), 20)
    print(json.dumps(dict(card=card, shape=SHAPE, m=M, K=K, dtype="bf16", ms=ms,
                          k1_ms=k1, conv1_ms=conv1, equal_to_separate=equal)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
