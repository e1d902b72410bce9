"""Where the time of the fused group's bf16 conv and weight gradient goes.

    python -m sres_tpu_torch.probes.fg_variants

Builds variants of ``ops/cuda/fused_group.cu`` from edited copies of the
source into ``_build/probe_fg/`` (one nvcc each, all at once) and times, in
device time at (72, 64, 48, 48) bf16, the conv in the five modes a fused
training step calls (``fg_ab.py``'s) and the weight gradient in its three:

- ``base``: the source as it is;
- ``mma_only``: no copies into the ring and no epilogue (the conv) or
  reduction (the wgrad): the products, barriers and waits alone;
- ``no_load``: no copies into the ring (the products read stale stages);
- ``no_epilogue``: the conv skips its epilogue, the wgrad its reduction;
- ``no_final``: the wgrad's last cluster skips the sum of the partials;
- ``no_mma``: no products;
- ``prof``: clock counters, cycles a tile: the conv's consumer warpgroups
  waiting for a stage, from the wait to the products' end, in the epilogue,
  and the prologue producer's load issue, wait for a free stage and store;
  cycles a block of the wgrad's reduction phases.

The text edits must match the source: a change there needs them updated.
Needs a CUDA card and nvcc; prints one JSON line per variant with the card's
name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import numpy as np

SHAPE = (72, 64, 48, 48)
SLEEP_CYCLES = 50_000_000      # as fg_ab.py: the host queues the calls meanwhile

CONV_MMA = "        wgmma_m64n128_kk(acc, wdesc"
WG_MMA = "          wgmma_m64n64_tt(acc[kx]"
CONV_LOAD = "        load_halo(sb + kCX"
CONV_LOAD_PRO = "        if (tile + (int)gridDim.x < ntiles)\n          halo_ld(nxt"
WG_LOAD_X = "      load_halo(sb + s * kWgStage"
WG_LOAD_G = "      load_gtile(sb + s * kWgStage"
CONV_EPI = ("    if (lane == 0) mbar_arrive(empty0 + 8 * s);   "
            "// the products have read the stage\n")
WG_RED = "  __syncthreads();                             // the ring is free\n"
WG_FINAL = "  if (!*flag) return;\n"

NO_LOAD = [(CONV_LOAD, "        if (k < 0) load_halo(sb + kCX"),
           (CONV_LOAD_PRO, "        if (tile < 0)\n          halo_ld(nxt"),
           (WG_LOAD_X, "      if (k < 0) load_halo(sb + s * kWgStage"),
           (WG_LOAD_G, "      if (k < 0) load_gtile(sb + s * kWgStage")]
NO_EPI = [(CONV_EPI, CONV_EPI + "    if (ntiles > 0) continue;\n"),
          (WG_RED, WG_RED + "  if (ntiles > 0) return;\n")]

PROF = [
    ("namespace {\n\nconstexpr int kTH",
     "__device__ unsigned long long g_prof[32];\n"
     "#define PROF(i) { const unsigned long long t_ = clock64(); acc_t[i] += t_ - t_last; "
     "t_last = t_; }\nnamespace {\n\nconstexpr int kTH"),
    ('}  // extern "C"',
     "int probe_prof(unsigned long long* out, int reset) {\n"
     "  if (reset) { unsigned long long z[32] = {0}; "
     "return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n"
     "  return (int)cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof));\n"
     '}\n}  // extern "C"'),
    # the conv: producer (prologue path) and consumers
    ("  const int ntiles = a.nimg * bf_tiles_per_img(a.h, a.w);\n  if (warp >= 4 * kConvWG) {",
     "  const int ntiles = a.nimg * bf_tiles_per_img(a.h, a.w);\n"
     "  unsigned long long acc_t[8] = {0}, t_last = clock64();\n"
     "  if (warp >= 4 * kConvWG) {"),
    ("        if (k >= kConvStages) mbar_wait(empty0 + 8 * s, (k / kConvStages - 1) & 1);\n"
     "        halo_st_prologue(",
     "        PROF(5)\n"
     "        if (k >= kConvStages) mbar_wait(empty0 + 8 * s, (k / kConvStages - 1) & 1);\n"
     "        PROF(3)\n        halo_st_prologue("),
    ("        fence_proxy_async();\n        mbar_arrive(full0 + 8 * s);\n      };",
     "        fence_proxy_async();\n        mbar_arrive(full0 + 8 * s);\n        PROF(4)\n      };"),
    ("    return;\n  }\n\n  setmaxnreg_inc<",
     "    if ((tid & 127) == 0) { for (int i = 3; i < 6; ++i) atomicAdd(&g_prof[i], acc_t[i]); "
     "atomicAdd(&g_prof[7], 1ull); }\n    return;\n  }\n\n  setmaxnreg_inc<"),
    ("    const int s = k % kConvStages;\n    const BTile t = btile(tile, a.h, a.w);",
     "    PROF(2)\n    const int s = k % kConvStages;\n    const BTile t = btile(tile, a.h, a.w);"),
    ("    mbar_wait(full0 + 8 * s, (k / kConvStages) & 1);\n",
     "    mbar_wait(full0 + 8 * s, (k / kConvStages) & 1);\n    PROF(0)\n"),
    ("    reg_fence(acc);\n", "    reg_fence(acc);\n    PROF(1)\n"),
    ("red[3 * kC + ct];\n    }\n  }\n}\n",
     "red[3 * kC + ct];\n    }\n  }\n  PROF(2)\n"
     "  if (ct == 0) { for (int i = 0; i < 3; ++i) atomicAdd(&g_prof[i], acc_t[i]); "
     "atomicAdd(&g_prof[6], 1ull); }\n}\n"),
    # the wgrad's reduction, thread 0 of each block
    (WG_RED, WG_RED + "  unsigned long long acc_t[8] = {0}, t_last = clock64();\n"),
    ("  cluster.sync();                              // every block's partial is in place\n",
     "  PROF(0)\n"
     "  cluster.sync();                              // every block's partial is in place\n"
     "  PROF(1)\n"),
    ("  __threadfence();\n  cluster.sync();                              "
     "// the cluster's partial is out\n",
     "  PROF(2)\n  __threadfence();\n  cluster.sync();                              "
     "// the cluster's partial is out\n  PROF(3)\n"),
    (WG_FINAL, "  PROF(4)\n  if (tid == 0) { for (int i = 0; i < 5; ++i) "
     "atomicAdd(&g_prof[10 + i], acc_t[i]); atomicAdd(&g_prof[16], 1ull); }\n" + WG_FINAL),
]

VARIANTS = {
    "base": [],
    "mma_only": NO_LOAD + NO_EPI,
    "no_load": NO_LOAD,
    "no_epilogue": NO_EPI,
    "no_final": [(WG_FINAL, "  if (!*flag || ntiles > 0) return;\n")],
    "no_mma": [(CONV_MMA, "        if (tap < 0) wgmma_m64n128_kk(acc, wdesc"),
               (WG_MMA, "          if (kx < 0) wgmma_m64n64_tt(acc[kx]")],
    "prof": PROF,
}


def edited(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise SystemExit(f"probe edit does not match the source once: {old[:70]!r}")
        src = src.replace(old, new)
    return src


class _Mix:
    """The variant's fused-group entries, the built library's others."""

    def __init__(self, main, var):
        self.main, self.var = main, var

    def __getattr__(self, name):
        return getattr(self.var if name.startswith("sres_fg") else self.main, name)


def _bind(so):
    lib = ctypes.CDLL(str(so))
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("sres_fg_tiles", [i] * 3),
                       ("sres_fg_conv", [vp] * 10 + [i] * 7 + [vp]),
                       ("sres_fg_wgrad_scratch", [i] * 5),
                       ("sres_fg_wgrad", [vp] * 5 + [i] + [vp] * 3 + [i] * 5 + [vp])):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = args
    if hasattr(lib, "probe_prof"):
        lib.probe_prof.restype = i
        lib.probe_prof.argtypes = [vp, i]
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from sres_tpu_torch.ops import cuda
    from sres_tpu_torch.ops import fused_group as fg
    main_lib = cuda.load()
    src = (cuda.SOURCE_DIR / "fused_group.cu").read_text()
    out = cuda.BUILD_DIR / "probe_fg"
    procs = {}
    for name, edits in VARIANTS.items():
        d = out / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        (d / "fused_group.cu").write_text(edited(src, edits))
        for h in ("ca_common.cuh", "wino_common.cuh"):
            shutil.copy(cuda.SOURCE_DIR / h, d)
        procs[name] = subprocess.Popen(
            [cuda.nvcc_path(), *cuda.ARCH_FLAGS, *cuda.NVCC_FLAGS, "-shared", "-o",
             str(d / "lib.so"), str(d / "fused_group.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{log[-3000:]}")
        libs[name] = _Mix(main_lib, _bind(out / name / "lib.so"))

    dev, cl = torch.device("cuda"), torch.channels_last
    rng = np.random.default_rng(10)
    f32 = lambda *s, sc=1.0: torch.from_numpy(
        (rng.normal(size=s) * sc).astype(np.float32)).to(dev)
    x, g = (f32(*SHAPE).bfloat16().contiguous(memory_format=cl) for _ in range(2))
    m = torch.relu(f32(*SHAPE)).bfloat16().contiguous(memory_format=cl)
    wk = fg.conv_weights(f32(64, 64, 3, 3, sc=0.04), torch.bfloat16)
    b = f32(64, sc=0.04)
    gate, ds = f32(SHAPE[0], 64).sigmoid(), f32(SHAPE[0], 64, sc=1e-2)
    part = f32(SHAPE[0], 18, 64)
    calls = {"conv relu": lambda: fg.fgroup_conv(x, wk, b, relu=True),
             "conv f32_partials": lambda: fg.fgroup_conv(x, wk, b, out_dtype=torch.float32,
                                                         partials=True),
             "conv residual": lambda: fg.fgroup_conv(x, wk, b, res=g),
             "conv dgrad_mask": lambda: fg.fgroup_conv(x, wk, gate=gate, ds=ds, mask=m,
                                                       partials=True),
             "conv dgrad_carry": lambda: fg.fgroup_conv(x, wk, res=g, res2=m),
             "wgrad plain": lambda: fg.fgroup_wgrad(x, g),
             "wgrad prologue": lambda: fg.fgroup_wgrad(x, g, gate=gate, ds=ds),
             "wgrad db_part": lambda: fg.fgroup_wgrad(x, g, db_part=part)}

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
    ntiles = SHAPE[0] * ((SHAPE[2] + 15) // 16) * ((SHAPE[3] + 7) // 8)
    for name, lib in libs.items():
        cuda._lib = lib
        res = {}
        for call, fn in calls.items():
            if name != "prof":
                res[call] = ms(fn)
                continue
            counters = (ctypes.c_ulonglong * 32)()
            lib.var.probe_prof(counters, 1)
            fn()
            torch.cuda.synchronize()
            lib.var.probe_prof(counters, 0)
            v = list(counters)
            if call.startswith("wgrad"):
                nb = max(v[16], 1)
                res[call] = dict(blocks=v[16], cycles_a_block=dict(
                    partial_to_smem=v[10] / nb, cluster_wait=v[11] / nb,
                    dsmem_sum=v[12] / nb, partial_out_wait=v[13] / nb, ticket=v[14] / nb))
            else:
                res[call] = dict(cycles_a_tile=dict(
                    consumer_stage_wait=v[0] / ntiles, consumer_to_products_end=v[1] / ntiles,
                    consumer_epilogue=v[2] / ntiles, producer_load_issue=v[5] / ntiles,
                    producer_free_stage_wait=v[3] / ntiles, producer_store=v[4] / ntiles))
        print(json.dumps(dict(variant=name, card=card, shape=SHAPE, bf16_device_ms=res)),
              flush=True)
    cuda._lib = main_lib
    return 0


if __name__ == "__main__":
    sys.exit(main())
