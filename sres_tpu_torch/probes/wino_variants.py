"""Probe of where the Winograd conv kernel's time goes
(ops/cuda/winograd.cu, ``wino_conv_wgmma_kernel``): builds variants of
winograd.cu from edited copies of the source into
``sres_tpu_torch/_build/probe_wino/`` and times each at the flagship shape
(72, 64, 48, 48), bf16, ReLU, m = 4 and m = 2; then times the chain kernel
at K = 1, 2, 4 and 20 against single launches. Needs a CUDA card and nvcc:

    python -m sres_tpu_torch.probes.wino_variants

Variants (wrong results, timing only, except ``base`` and ``clocks``):
``no_transform`` (phase A, the input transform, skipped), ``no_products``
(no wgmma), ``no_fold`` (no inverse-transform fold), ``no_exchange`` (no
DSMEM writes of the partial sums), ``no_epilogue`` (no staging, no
stores), ``products_only`` (neither transform, fold nor epilogue), and
``clocks``: per warpgroup unit and warp, the cycles of (A) the input
transform, (B) the products and fold (with the wait for U), (X) the
residual's loads, the wait for the peer warpgroup's products and the
DSMEM writes, (C) the wait for the peer's partial sums and the epilogue,
and the last barrier, over every call. The text edits must match the
source: a change there needs them updated.
Prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import numpy as np

A = "    produce_v<M, C0, kCoherent>(a.x, vs, tref, a.h, a.w, wt);"
MMA = "          wgmma_ss<TW>(acc[ti], udesc"
FOLD = ("#pragma unroll\n      for (int e = 0; e < E; ++e) {\n"
        "        float f[N], r[M];")
X = "        peer[(e * NG + k) * 128 + wt] = v;"
C1 = ("      unsigned char* row = vs + tile * G::kStgTile + (16 * wq + g8 + 8 * i) * 2;\n"
      "#pragma unroll\n      for (int px = 0; px < H; ++px) {")
C2 = "      *reinterpret_cast<uint4*>(a.y + off) = o;"
NEVER = "uend < 0"            # false at run time, unknown to the compiler

SKIP_A = [(A, f"    if ({NEVER}) " + A.strip())]
SKIP_FOLD = [(FOLD, f"      if ({NEVER})\n" + FOLD)]
SKIP_C = [(C1, C1.replace("#pragma unroll\n      for (int px = 0; px < H; ++px) {",
                          f"#pragma unroll\n      for (int px = 0; px < H && !({NEVER}); ++px) {{")),
          (C2, f"      if ({NEVER}) " + C2.strip())]
CLOCKS = [
    ("namespace {\n\n// ------------------------------------------------------ kernel (a): conv",
     "__device__ unsigned long long g_clk[8];\n"
     "extern \"C\" int probe_clocks(void* out) {\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk));\n}\n"
     "namespace {\n\n// ------------------------------------------------------ kernel (a): conv"),
    ("    unit_tiles<M>(tref, u0, uend, a.h, a.w, wt);",
     "    const long long c0 = clock64();\n    unit_tiles<M>(tref, u0, uend, a.h, a.w, wt);"),
    ("    fence_proxy_async();                   // V's generic stores, for wgmma",
     "    const long long c1 = clock64();\n"
     "    fence_proxy_async();                   // V's generic stores, for wgmma"),
    ("    // this warpgroup's products have read its V: the peer may write there",
     "    const long long c2 = clock64();\n"
     "    // this warpgroup's products have read its V: the peer may write there"),
    ("    // (C) columns 0..n/2-1 first;",
     "    const long long c3 = clock64();\n    // (C) columns 0..n/2-1 first;"),
    ("    named_bar(bar_id, 128);                // the staging is read before V is rewritten\n",
     "    const long long c4 = clock64();\n"
     "    named_bar(bar_id, 128);                // the staging is read before V is rewritten\n"
     "    if (lane == 0) {\n"
     "      const long long t[5] = {c1 - c0, c2 - c1, c3 - c2, c4 - c3, clock64() - c4};\n"
     "      for (int k = 0; k < 5; ++k) atomicAdd(&g_clk[k], (unsigned long long)t[k]);\n"
     "      atomicAdd(&g_clk[5], 1ull);\n    }\n"),
]
VARIANTS = {
    "base": [],
    "no_transform": SKIP_A,
    "no_products": [(MMA, f"          if ({NEVER}) wgmma_ss<TW>(acc[ti], udesc")],
    "no_fold": SKIP_FOLD,
    "no_exchange": [(X, f"        if ({NEVER}) peer[(e * NG + k) * 128 + wt] = v;")],
    "no_epilogue": SKIP_C,
    "products_only": SKIP_A + SKIP_FOLD + SKIP_C,
    "clocks": CLOCKS,
}
PHASES = ["A transform", "B products+fold", "X exchange", "C epilogue", "last barrier"]
SHAPE = (72, 64, 48, 48)


def edited(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"probe edit does not match the source once: {old[:70]!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from sres_tpu_torch.ops import cuda
    from sres_tpu_torch.ops import winograd_conv as twc
    from sres_tpu_torch.ops.winograd import transform_weights
    cuda.load()
    src = (cuda.SOURCE_DIR / "winograd.cu").read_text()
    out = cuda.BUILD_DIR / "probe_wino"
    procs = {}
    for name, edits in VARIANTS.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "winograd.cu").write_text(edited(src, edits))
        shutil.copy(cuda.SOURCE_DIR / "wino_common.cuh", d)
        procs[name] = subprocess.Popen(
            [cuda.nvcc_path(), *cuda.ARCH_FLAGS, *cuda.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "winograd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        lib = ctypes.CDLL(str(out / name / "lib.so"))
        lib.sres_wino_conv.restype = i
        lib.sres_wino_conv.argtypes = [vp] * 5 + [i] * 6 + [f, i, vp]
        if name == "clocks":
            lib.probe_clocks.restype = i
            lib.probe_clocks.argtypes = [vp]
        libs[name] = lib

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32)).to(dev).bfloat16()
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy((rng.normal(size=(64, 64, 3, 3)) * 0.04).astype(np.float32)).to(dev)
    b = torch.zeros(64, device=dev)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def device_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / iters

    res = {}
    for m in (4, 2):
        u = twc._operand(transform_weights(w, m).to(torch.bfloat16), m, x, 64)
        for name, lib in libs.items():
            def call(lib=lib):
                err = lib.sres_wino_conv(x.data_ptr(), u.data_ptr(), b.data_ptr(), None,
                                         y.data_ptr(), SHAPE[0], SHAPE[2], SHAPE[3], m, 1, 1,
                                         1.0, 0, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            res[f"m{m} {name} ms"] = device_ms(call)
            if name == "clocks":
                buf = (ctypes.c_ulonglong * 8)()
                if lib.probe_clocks(ctypes.addressof(buf)):
                    raise RuntimeError("probe_clocks failed")
                n = max(buf[5], 1)
                res[f"m{m} cycles a unit a warp"] = {PHASES[k]: buf[k] / n for k in range(5)}
    # the chain at K convs against K single launches (U in the kernels' order)
    ws = torch.from_numpy((rng.normal(size=(20, 64, 64, 3, 3)) * 0.04).astype(np.float32)).to(dev)
    bv = torch.zeros(20, 64, device=dev)
    kus = twc.kernel_u(transform_weights(ws, 4).to(torch.bfloat16))
    for k in (1, 2, 4, 20):
        def single(k=k):
            yy = x
            for j in range(k):
                yy = twc.wino_conv(yy, kus[j], bv[j], 4, relu=True)
        res[f"chain K={k} ms"] = device_ms(lambda k=k: twc.wino_chain_fwd(x, kus[:k], bv[:k], 4),
                                           iters=5)
        res[f"{k} launches ms"] = device_ms(single, iters=5)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(card=card, shape=SHAPE, dtype="bf16", device_ms=res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
