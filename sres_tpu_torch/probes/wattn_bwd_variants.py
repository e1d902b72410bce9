"""Probe of where the window-attention core kernels' time goes
(ops/cuda/window_attention.cu, ``wattn_bwd_core_kernel`` and
``wattn_fwd_core_kernel``, which share stages (B)-(E)): builds variants of
the kernel library from edited copies of the source and times each through
``window_attention_bwd`` (cases ``t64``, ``t256``) and ``window_attention``
(``fwd t64``, ``fwd t256``) at SwinIR's shape (1728 windows of T = 64) and
SwinIR-w16's (432 of T = 256), bf16, C 64, 4 heads, shifted (the 96×96
tile's group mask). Needs a CUDA card and nvcc:

    python -m sres_tpu_torch.probes.wattn_bwd_variants

Variants; every one but ``shipped`` and the two ``fwd_*`` computes wrong
results (timing only). The forward's design choices, each undone:
``fwd_mask_every_window`` (the mask read from L2 for every window, not
kept in registers across the windows of one w % nm group) and
``fwd_kv_full_barriers`` (a full cluster barrier after each window's p.V in
place of the split arrive / wait before the next k, v push). And
``fwd_phases``, the shipped kernels with clock counters: thread 0 of each
forward core CTA adds the cycles of each phase of every window to device
counters, read after one call (cycles per CTA, summed over its windows).
The rest:
``no_bias_mask`` (the score epilogue adds neither bias nor mask),
``no_scores`` (no q.K^T, do.V^T), ``no_o_dq`` (no p.V, ds.K),
``no_dk_dv_dwo`` (no ds^T q, p^T do, o^T g), ``no_projection`` (no
x.Wqkv), ``no_exp`` (the softmax's exp skipped), ``no_exchange_barrier``
(the cluster barrier before the dk | dv exchange made a CTA barrier).
Also the most clusters of the core kernel the card holds at once
(cudaOccupancyMaxActiveClusters, at T = 64, 144 and 256) and the shipped
kernels at several core-grid sizes (the wrapper's CTA targets). Prints
one JSON line: ms per call (CUDA events, 10 calls after 3 warm-up calls,
two readings each), each variant's ptxas register and spill lines for the
core kernels, the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import numpy as np
import torch

from sres_tpu_torch.models.swinir import shift_attn_mask
from sres_tpu_torch.ops import cuda
from sres_tpu_torch.ops import window_attention as twa

# the most clusters of ceil(T / 64) bf16 core CTAs (head width 16) resident
# at once; appended to every variant's copy of the source
CLUSTERS = """
extern "C" int sres_probe_max_clusters(int t, int heads) {
  const int nq = (t + 63) / 64;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nq * heads * 8);
  cfg.blockDim = dim3(::kBT);
  cfg.dynamicSmemBytes = ::core_smem<bf16>(t, 16).bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nq;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaFuncSetAttribute(::wattn_bwd_core_kernel<bf16, 16>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)::core_smem<bf16>(256, 16).bytes);
  int n = -1;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, ::wattn_bwd_core_kernel<bf16, 16>, &cfg);
  return e == cudaSuccess ? n : -(int)e;
}
"""
SKIP = "if (gridDim.x == 0) "   # a product the variant never runs
# An edit applies to every copy of its text: the scores' product and the exp
# are the same text in both core kernels.
VARIANTS = {
    "shipped": [],
    "no_bias_mask": [
        ("            const float2 b = ldg2(bias_h + i);",
         "            const float2 b = make_float2(0.0f, 0.0f);"),
        ("            if (maskw != nullptr) {\n              const float2 m = ldg2(maskw + i);",
         "            if (false) {\n              const float2 m = ldg2(maskw + i);"),
        ("        const float2 b = *reinterpret_cast<const float2*>(bias_r + r * ldb + col);",
         "        const float2 b = make_float2(0.0f, 0.0f);"),
        ("        if (masked) {", "        if (false) {")],
    "no_scores": [
        ("  warp_mma<E, false, false, NT>(sc, qs,", f"  {SKIP}warp_mma<E, false, false, NT>(sc, qs,"),
        ("    if (live) warp_mma<E, false, false, NT>(dp, dos,",
         f"    {SKIP}warp_mma<E, false, false, NT>(dp, dos,")],
    "no_o_dq": [
        ("    warp_mma<E, false, true, 2>(acc, pb, ldp,", f"    {SKIP}warp_mma<E, false, true, 2>(acc, pb, ldp,"),
        ("        warp_mma<E, false, true, 2>(acc, dsb, L.ldp",
         f"        {SKIP}warp_mma<E, false, true, 2>(acc, dsb, L.ldp")],
    "no_dk_dv_dwo": [
        ("      warp_mma<E, true, true, hd / 8>(dvp, pb", f"      {SKIP}warp_mma<E, true, true, hd / 8>(dvp, pb"),
        ("      warp_mma<E, true, true, hd / 8>(dkp, dsb", f"      {SKIP}warp_mma<E, true, true, hd / 8>(dkp, dsb"),
        ("    if (wlive) warp_mma<E, true, true, 1>(dwo", f"    {SKIP}warp_mma<E, true, true, 1>(dwo")],
    "no_projection": [
        ("    warp_mma<E, false, true, 2>(acc, xs, ldx,", f"    {SKIP}warp_mma<E, false, true, 2>(acc, xs, ldx,")],
    "no_exp": [("expf(sc[j][", "(sc[j][")],
    "no_exchange_barrier": [("    cluster.sync();   // every CTA's partial complete",
                             "    __syncthreads();")],
    # the shipped forward with clock counters per phase (PHASE_EXTRA)
    "fwd_phases": [
        ("namespace {\n\nconstexpr int kC3", "namespace {\n" + "__device__ unsigned long long g_ph[16];\n"
         "#define PH(k) if (threadIdx.x == 0) { const unsigned long long n_ = clock64(); "
         "atomicAdd(&g_ph[k], n_ - t_); t_ = n_; }\n\nconstexpr int kC3"),
        ("  if (nq > 1) cluster_arrive();\n  for (int i = w0; i < w1; ++i) {\n"
         "    const int w = window(i);\n    cp_async_wait<0>();\n    __syncthreads();\n",
         "  unsigned long long t_ = clock64();\n  if (threadIdx.x == 0) atomicAdd(&g_ph[15], 1ull);\n"
         "  if (nq > 1) cluster_arrive();\n  for (int i = w0; i < w1; ++i) {\n"
         "    const int w = window(i);\n    cp_async_wait<0>();\n    __syncthreads();\n    PH(0)\n"),
        ("    stage_qkv<E, HD>(xs, L.ldx, wq, L.ldw, bq, qs, ks, vs, L.ldh, q0, rows);   // (B)\n"
         "    __syncthreads();\n    if (i + 1 < w1)",
         "    stage_qkv<E, HD>(xs, L.ldx, wq, L.ldw, bq, qs, ks, vs, L.ldh, q0, rows);   // (B)\n"
         "    __syncthreads();\n    PH(1)\n    if (i + 1 < w1)"),
        ("      cluster_wait();\n      push_kv", "      cluster_wait();\n      PH(2)\n      push_kv"),
        ("      cluster.sync();   // K, V whole in every CTA\n    }\n",
         "      cluster.sync();   // K, V whole in every CTA\n    }\n    PH(3)\n"),
        ("    stage_softmax<E, NT>(sc, red0, red1, pb, L.ldp, rg, cgi, n0, nt, live);   // (D)\n",
         "    PH(4)\n    stage_softmax<E, NT>(sc, red0, red1, pb, L.ldp, rg, cgi, n0, nt, live);   // (D)\n"),
        ("    __syncthreads();   // p whole\n", "    __syncthreads();   // p whole\n    PH(5)\n"),
        ("    if (nq > 1) cluster_arrive();   // K, V read\n",
         "    PH(6)\n    if (nq > 1) cluster_arrive();   // K, V read\n")],
    # correct variants of the forward's design choices
    "fwd_mask_every_window": [("(i == w0 || i % per == 0)", "true")],
    "fwd_kv_full_barriers": [
        ("  if (nq > 1) cluster_arrive();\n  for (int i = w0;", "  if (nq > 1) cluster.sync();\n  for (int i = w0;"),
        ("      cluster_wait();\n      push_kv", "      push_kv"),
        ("    if (nq > 1) cluster_arrive();   // K, V read", "    if (nq > 1) cluster.sync();   // K, V read"),
        ("  if (nq > 1) cluster_wait();\n}", "}")],
}
# the phases of one forward window the counters split a call into (thread
# 0's clock, warp 0's share of the work; barriers wait for the slowest warp)
FWD_PHASES = ["x wait", "projection", "k, v wait", "k, v push + cluster barrier",
              "scores", "softmax + barrier", "p.V"]
PHASE_EXTRA = """
extern "C" int probe_phases(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_ph, sizeof(g_ph));
}
extern "C" int probe_reset() {
  unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(g_ph, z, sizeof(z));
}
"""
GRIDS = ((128, 120), (128, 128), (96, 96), (112, 112), (192, 192), (256, 256), (512, 512))


def build_variants() -> dict:
    """Every variant's library (its window_attention.cu, the other sources
    compiled once), one nvcc each, started together, into
    sres_tpu_torch/_build/probe_wattn/; returns {name: (lib, ptxas lines)}."""
    out = cuda.BUILD_DIR / "probe_wattn"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    nvcc, flags = cuda.nvcc_path(), cuda.ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    srcs, _ = cuda.sources()
    others = [f for f in srcs if f.name != "window_attention.cu"]
    jobs = {f.stem: (out / f"{f.stem}.o", [f]) for f in others}
    shipped = (cuda.SOURCE_DIR / "window_attention.cu").read_text()
    for name, edits in VARIANTS.items():
        text = shipped
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the probe's edit point is gone: {old!r}")
            text = text.replace(old, new)
        (out / f"wa_{name}.cu").write_text(text + CLUSTERS + (PHASE_EXTRA if name == "fwd_phases"
                                                              else ""))
        jobs[f"wa_{name}"] = (out / f"wa_{name}.o", [out / f"wa_{name}.cu", "-Xptxas", "-v"])
    procs = {k: subprocess.Popen([nvcc, *flags, "-I", str(cuda.SOURCE_DIR), "-c", "-o", str(o),
                                  *map(str, args)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for k, (o, args) in jobs.items()}
    logs = {k: p.communicate()[0] for k, p in procs.items()}
    for k, p in procs.items():
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {k}:\n{logs[k]}")
    libs = {}
    for name in VARIANTS:
        so = out / f"lib_{name}.so"
        subprocess.run([nvcc, *cuda.ARCH_FLAGS, "-shared", "-o", str(so), str(out / f"wa_{name}.o"),
                        *[str(out / f"{f.stem}.o") for f in others]], check=True)
        lib = cuda._bind(ctypes.CDLL(str(so)))
        lib.sres_probe_max_clusters.restype = ctypes.c_int
        lib.sres_probe_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
        ptxas, kernel = [], None
        for ln in logs[f"wa_{name}"].splitlines():
            if "Compiling entry function" in ln:
                kernel = ln.split("'")[1] if "'" in ln else ln
            elif kernel and "_core_kernel" in kernel and ("Used" in ln or "spill" in ln):
                which = "fwd" if "wattn_fwd" in kernel else "bwd"
                ptxas.append(f"{which}: " + ln.split(":", 1)[-1].strip())
        libs[name] = (lib, ptxas)
    return libs


def time_ms(fn, iters: int = 10) -> float:
    for _ in range(3):
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
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    libs = build_variants()
    cases = {}
    for side, nw in ((8, 1728), (16, 432)):
        t = side * side
        rng = np.random.default_rng(side)
        f32 = lambda *s, sc=1.0: torch.from_numpy(
            (rng.normal(size=s) * sc).astype(np.float32)).to(dev)
        x, g = f32(nw, t, 64).bfloat16(), f32(nw, t, 64).bfloat16()
        ws = [f32(64, 192, sc=0.1), f32(192, sc=0.1), f32(64, 64, sc=0.1), f32(64, sc=0.1),
              f32(4, t, t, sc=0.02)]
        mask = torch.from_numpy(shift_attn_mask(96, 96, side, side // 2)).to(dev)
        cases[f"t{t}"] = lambda x=x, g=g, ws=ws, mask=mask: twa.window_attention_bwd(
            x, g, *ws, mask, 4)
        cases[f"fwd t{t}"] = lambda x=x, ws=ws, mask=mask: twa.window_attention(x, *ws, mask, 4)
    saved_lib, saved_grid = cuda._lib, (twa._CORE_CTAS, twa._CORE_CLUSTER_CTAS)
    try:
        variants = {}
        for name, (lib, ptxas) in libs.items():
            cuda._lib = lib
            variants[name] = dict(ptxas=ptxas, **{k: [time_ms(fn) for _ in range(2)]
                                                  for k, fn in cases.items()})
        lib = cuda._lib = libs["fwd_phases"][0]
        lib.probe_phases.argtypes, lib.probe_reset.argtypes = [ctypes.c_void_p], []
        phases = {}
        for k in ("fwd t64", "fwd t256"):
            counts = (ctypes.c_ulonglong * 16)()
            lib.probe_reset()
            cases[k]()
            torch.cuda.synchronize()
            lib.probe_phases(counts)
            phases[k] = dict(ctas=counts[15], cycles_per_cta={
                ph: counts[j] / max(counts[15], 1) for j, ph in enumerate(FWD_PHASES)})
        cuda._lib = libs["shipped"][0]
        clusters = {f"t{t}": cuda._lib.sres_probe_max_clusters(t, 4) for t in (64, 144, 256)}
        grids = {}
        for ctas, cluster_ctas in GRIDS:
            twa._CORE_CTAS, twa._CORE_CLUSTER_CTAS = ctas, cluster_ctas
            grids[f"{ctas}/{cluster_ctas}"] = {k: time_ms(fn) for k, fn in cases.items()}
    finally:
        cuda._lib = saved_lib
        twa._CORE_CTAS, twa._CORE_CLUSTER_CTAS = saved_grid
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(card=card, variants_ms=variants, fwd_phases=phases,
                          max_active_clusters=clusters,
                          grid_ms=grids)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
