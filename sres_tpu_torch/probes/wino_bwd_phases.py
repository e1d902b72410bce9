"""Where the conv adjoint's time goes: clock counters per phase, on the card.

    python -m sres_tpu_torch.probes.wino_bwd_phases

Builds two edited copies of ``ops/cuda/winograd_bwd.cu`` into
``sres_tpu_torch/_build/probe_wino_bwd/`` (bf16 activations and cotangent
only): ``phases``, where thread 0 of every CTA adds the clock cycles
between the kernels' barriers to per-phase device counters, and
``no_push``, the same without the dU kernel's bulk copies of dM through
distributed shared memory (its dU is wrong; only its time is read). Runs
each on the ``relu`` mode at the flagship shape (72, 64, 48, 48) from a
fixed numpy seed, and prints one JSON line: each kernel's device time
(torch.profiler, mean of 10 calls), the cycles per CTA of each phase of a
call, how many clusters of each kernel the card holds at once
(``cudaOccupancyMaxActiveClusters``), and the card's name and power limit.
Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np

# phases the counters split a call into (cycles per CTA, summed over passes)
DX_PHASES = ["prologue", "tap rows", "band zeroing", "overlap-add", "write-out", "exchange"]
DU_PHASES = ["recompute", "push", "products"]

_COUNTERS = """namespace cg = cooperative_groups;
__device__ unsigned long long g_ph[16];
#define PH(k) if (threadIdx.x == 0) { unsigned long long n_ = clock64(); \\
    atomicAdd(&g_ph[k], n_ - t_); t_ = n_; }
"""
# (text in the source, text that replaces it)
PHASES = [
    ("namespace cg = cooperative_groups;\n", _COUNTERS),
    ("  float dbacc = 0.0f;\n", "  float dbacc = 0.0f;\n  unsigned long long t_ = clock64();\n"),
    ("    }\n    __syncthreads();\n\n    // (b) dV",
     "    }\n    __syncthreads();\n    PH(0)\n\n    // (b) dV"),
    ("    __syncthreads();        // s2 whole\n", "    __syncthreads();        // s2 whole\n    PH(1)\n"),
    ("band[z + i] = 0.0f;\n      __syncthreads();\n",
     "band[z + i] = 0.0f;\n      __syncthreads();\n      PH(2)\n"),
    ("        __syncthreads();\n      }\n      for (int it = tid; it < cols * (cgn / 2)",
     "        __syncthreads();\n      }\n      PH(3)\n      for (int it = tid; it < cols * (cgn / 2)"),
    ("      __syncthreads();      // the band is free for the next round\n",
     "      __syncthreads();      // the band is free for the next round\n      PH(4)\n"),
    ("  cluster.sync();           // no CTA leaves while a neighbour reads its rows\n",
     "  cluster.sync();           // no CTA leaves while a neighbour reads its rows\n  PH(5)\n"
     "  if (threadIdx.x == 0) atomicAdd(&g_ph[6], 1ull);\n"),
    ("  const int nq = warp & 3, tw0 = warp >> 2;\n",
     "  const int nq = warp & 3, tw0 = warp >> 2;\n  unsigned long long t_ = clock64();\n"
     "  if (threadIdx.x == 0) atomicAdd(&g_ph[11], 1ull);\n"),
    ("    __syncthreads();        // this CTA's quarter of dM written\n",
     "    __syncthreads();        // this CTA's quarter of dM written\n    PH(8)\n"),
    ("    mbar_wait(bar, phase);  // dM whole in every CTA of the cluster\n",
     "    mbar_wait(bar, phase);  // dM whole in every CTA of the cluster\n    PH(9)\n"),
    ("    cluster.sync();         // no CTA reads V or dM of this pass any more\n",
     "    cluster.sync();         // no CTA reads V or dM of this pass any more\n    PH(10)\n"),
]
NO_PUSH = [("    if (tid == 0) {\n      asm volatile(\"mbarrier.arrive.expect_tx",
            "    if (false) {\n      asm volatile(\"mbarrier.arrive.expect_tx"),
           ("    mbar_wait(bar, phase);  // dM whole", "    // dM whole")]
ONLY_BF16 = [
    ("  if (!bf16_)\n    return dispatch_m<float, float>",
     "  if (0)\n    return dispatch_m<float, float>"),
    ("  if (g_f32)\n    return dispatch_m<bf16, float>",
     "  if (0)\n    return dispatch_m<bf16, float>"),
]
_EXTRA = """
extern "C" int probe_phases(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, g_ph, sizeof(g_ph));
}
extern "C" int probe_reset() {
  unsigned long long z[16] = {};
  return (int)cudaMemcpyToSymbol(g_ph, z, sizeof(z));
}
// clusters of the dx (which = 0: nb CTAs) or dU (1: kDuBlocks CTAs) kernel
// the card holds at once, at the flagship shape's shared memory
extern "C" int probe_clusters(int which, int h, int w) {
  const DxGeo geo = dx_geometry<bf16, 4>(h, w);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(Cfg<bf16>::kThr);
  cfg.dynamicSmemBytes = which ? 36 * Cfg<bf16>::TB * (kC + 16) * 2 + 16 : geo.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = which ? kDuBlocks : geo.nb;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(which ? kDuBlocks * kDuRanges : geo.nb * 72);
  int n = -1;
  cudaError_t e;
  if (which) {
    cudaFuncSetAttribute(wino_bwd_du_kernel<bf16, bf16, 4>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    e = cudaOccupancyMaxActiveClusters(&n, wino_bwd_du_kernel<bf16, bf16, 4>, &cfg);
  } else {
    cudaFuncSetAttribute(wino_bwd_dx_kernel<bf16, bf16, 4>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    e = cudaOccupancyMaxActiveClusters(&n, wino_bwd_dx_kernel<bf16, bf16, 4>, &cfg);
  }
  return e == cudaSuccess ? n : -(int)e;
}
"""


def _edit(src: str, subs) -> str:
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"probe edit does not match the source once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from sres_tpu_torch.ops import cuda
    from sres_tpu_torch.ops import winograd_conv as twc
    from sres_tpu_torch.ops.winograd import transform_weights
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    out_dir = cuda.BUILD_DIR / "probe_wino_bwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    base = (cuda.SOURCE_DIR / "winograd_bwd.cu").read_text()
    for h in ("ca_common.cuh", "wino_common.cuh"):
        base = base.replace(f'#include "{h}"', f'#include "{cuda.SOURCE_DIR / h}"')
    variants = {"phases": PHASES + ONLY_BF16, "no_push": PHASES + NO_PUSH + ONLY_BF16}
    nvcc = cuda.nvcc_path()
    procs = {}
    for name, subs in variants.items():
        src = out_dir / f"{name}.cu"
        src.write_text(_edit(base, subs) + _EXTRA)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda.ARCH_FLAGS, *cuda.NVCC_FLAGS, "-shared", "-o",
             str(out_dir / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log[-3000:]}")

    dev, cl = torch.device("cuda"), torch.channels_last
    rng = np.random.default_rng(8)
    f32 = lambda *s, sc=1.0: torch.from_numpy(
        (rng.normal(size=s) * sc).astype(np.float32)).to(dev)
    shape = (72, 64, 48, 48)
    xb = f32(*shape).contiguous(memory_format=cl).bfloat16()
    gb = f32(*shape).contiguous(memory_format=cl).bfloat16()
    u = transform_weights(f32(64, 64, 3, 3, sc=0.04), 4).bfloat16()
    ut = twc._operand(u, 4, xb, 64, bwd=True)
    yb = twc.wino_conv(xb, u, None, 4, relu=True)
    res = {}
    for name in variants:
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.sres_wino_bwd_scratch.restype = i
        lib.sres_wino_bwd_scratch.argtypes = [i] * 5
        lib.sres_wino_conv_bwd.restype = i
        lib.sres_wino_conv_bwd.argtypes = [vp] * 10 + [i] * 8 + [vp]
        lib.probe_clusters.argtypes = [i, i, i]
        scratch = torch.empty(lib.sres_wino_bwd_scratch(*shape[:1], *shape[2:], 4, 1),
                              device=dev)
        dx = torch.empty_like(xb, memory_format=cl)
        du, db = torch.empty(36, 64, 64, device=dev), torch.empty(64, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = lib.sres_wino_conv_bwd(
                gb.data_ptr(), xb.data_ptr(), yb.data_ptr(), ut.data_ptr(), None, None,
                scratch.data_ptr(), dx.data_ptr(), du.data_ptr(), db.data_ptr(),
                shape[0], shape[2], shape[3], 4, 1, 0, 0, dev.index or 0, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        kms = {e.key.split("::")[1].split("<")[0].split("(")[0]:
               e.self_device_time_total / e.count / 1e3
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        lib.probe_reset()
        call()
        torch.cuda.synchronize()
        ph = (ctypes.c_ulonglong * 16)()
        lib.probe_phases(ph)
        res[name] = dict(
            kernel_ms=kms,
            dx_cycles_per_cta=dict(zip(DX_PHASES, (v / max(ph[6], 1) for v in ph[:6]))),
            du_cycles_per_cta=dict(zip(DU_PHASES, (v / max(ph[11], 1) for v in ph[8:11]))),
            dx_ctas=ph[6], du_ctas=ph[11],
            clusters_at_once=dict(dx=lib.probe_clusters(0, shape[2], shape[3]),
                                  du=lib.probe_clusters(1, shape[2], shape[3])))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(card=card, shape=shape, mode="relu", **res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
