#!/usr/bin/env python3
"""Card smoke test of the PyTorch/H100 port (``sres_tpu_torch``).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card, ``nvcc`` and this checkout; imports no JAX and no YAML.
Phases, one line each (every line carries the card's name and power limit):

1. toolchain: torch / CUDA / nvcc versions, the kernel build time;
2. kernel (a), the Winograd conv (``wino_conv_wgmma_kernel``: clusters of two
   blocks, half of U resident in each), against its plain twin at (72, 64,
   48, 48), m ∈ {2, 4}, ReLU on/off, with and without the residual
   epilogue; U in the kernels' order (``WinoU``, as the module caches keep
   it) gives the natural U's bits; in device time (``device_ms``) in the
   modes the trunks call (ReLU, bias only, the residual at res_scale 1
   and 0.1; ReLU at m=2), against ``F.conv2d`` with bias on channels_last
   bf16 weights, the back-to-back events beside;
3. kernel (b), channel attention + block skip, against its plain twin at
   (72, 64, 48, 48) (``ca_cluster_kernel``: a cluster of 4 blocks a
   sample in bf16, 8 in f32, r read once) and at (2, 64, 192, 192)
   (``ca_two_pass_kernel``, one cooperative launch), timed in device time
   (``device_ms``) against its bound, the back-to-back events beside;
4. one full residual group (20 RCABs + trailing conv, m=4, batch 72);
5. the serving slice: RCAN-10-20-64 ×4 with ``winograd: 4``, bf16 compute,
   served through build_model → build_eval_step for three requests of 72
   HR tiles at 1×192×192, compared with the same model on the plain twins,
   timed against the plain twins and the direct (cuDNN) trunk, and profiled
   (device time by kernel for one request of the kernel and direct paths);
6. kernel (c), the conv backward (``wino_bwd_dx_kernel``,
   ``wino_bwd_du_kernel``, ``wino_bwd_sum_kernel``), against its plain twin
   at (72, 64, 48, 48), m ∈ {2, 4}, in its five modes: per-conv adjoint (g
   in the activation dtype, or f32 as EDSR's conv2 passes it), ReLU gate,
   CA prologue into an f32 dx, ReLU gate accumulated into an f32 buffer;
   two calls must give the same bits; each mode a training step calls
   (``relu``, ``ca``, ``accum``, ``f32g``) timed against its own bound and
   cuDNN's ``convolution_backward``, and a device-time profile of one call;
7. kernel (d), the channel-attention backward (``ca_skip_bwd_kernel``, one
   cooperative launch), against its plain twin at (72, 64, 48, 48), at
   samples too large for a block (2, 64, 192, 192) and at an odd pixel
   count (3, 64, 9, 13), c2 in f32 and bf16; two calls give the same bits;
   one call is one kernel (torch.profiler); device time (``device_ms``) in
   bf16, f32 and at (2, 64, 192, 192), the events beside, each against its
   bound;
8. one residual group's backward (20 RCABs + trailing conv, m=4, b72): the
   gradients of sum(y·G) and the stash, kernels against plain twins;
9. the train slice: the same model through build_model → build_optimizer →
   build_train_step (Adam, lr 1e-4, b72, 1×192×192 HR tiles): one step's
   loss and gradients against the plain twins, three Adam steps with their
   launch counts, ms/step and trained tiles/s against the direct cuDNN
   trunk under autograd, peak memory and a device-time profile of a step;
10. kernel (e), window attention (one design at every T: the cluster
   kernel wattn_fwd_core_kernel, then wattn_fwd_proj_kernel), against its
   plain twin at the SwinIR serving shape (1728 windows of 64 tokens, C 64,
   4 heads), unshifted and shifted (the 144-window group mask), timed
   against the composition F.linear → F.scaled_dot_product_attention →
   F.linear;
11. kernel (f), the window-attention backward (one design at every T: the
   cluster kernel wattn_bwd_core_kernel, then wattn_bwd_proj_kernel and
   fixed-order partial sums), against its plain twin at T = 64: dx and the
   five weight gradients, unshifted and shifted, timed against the
   composition's autograd backward;
12. SwinIR ×4 serving (config/model/swinir.yaml, bf16) through build_model →
   build_eval_step for three requests of 12 HR tiles of 1×384×384 (96×96
   LR, config/task/SST-tiles-96.yaml), 16 window-attention launches each,
   held against the same model on the plain twins, timed in turns against
   the same weights on the composition attention, and profiled;
13. SwinIR ×4 training: build_optimizer (Adam, lr 2e-4) → build_train_step
   at batch 12: one step's loss and gradients against the plain twins,
   three Adam steps on one batch (16 window_attention and 16
   window_attention_bwd launches each; the loss must fall), ms/step,
   trained tiles/s and peak memory against the composition attention, and
   a profile;
14. the direct-conv group kernels of ``model.fused`` against their plain
   twins at (72, 64, 48, 48) and a ragged (3, 64, 50, 38): the conv
   (``fg_conv_wgmma_kernel``: as conv1 with ReLU, as conv2 with f32 output
   and CA partials, with a residual, and as the dgrads of conv2 and conv1:
   CA prologue and mask, carried cotangent and group skip), the weight
   gradient (``fg_wgrad_wgmma_kernel``: plain, CA prologue, db from
   partials), gate + skip (``fg_ca_stream_kernel``, serving and with the
   stash, each against its own bound) and the CA backward
   (``fg_ca_bwd_kernel``, one cooperative launch; also at (2, 64, 192, 192)
   and (3, 64, 9, 13), the same bits on two calls, one kernel a call, timed
   at (2, 64, 192, 192) too); each mode timed
   in device time (``device_ms``; back-to-back events beside) against its
   bound and against ``F.conv2d`` and cuDNN's dgrad and wgrad,
   channels_last weights;
15. one fused group (20 RCABs + trailing conv, b72): forward, stash and
   gradients, kernels against twins (the rule of phase 8 for flipped
   gates; the backward kernels alone on one shared stash), timed against
   the same weights as a Winograd group and a direct cuDNN group;
16. RCAN-10-20-64 ×4 with ``fused: true`` served (three requests of 72
   tiles; 410 conv and 200 gate + skip launches each), held against the
   plain twins, timed in turns against the same weights on ``winograd: 4``
   and on the direct trunk, and profiled;
17. the same model trained (Adam, lr 1e-4, b72): one step's loss and
   gradients against the plain twins, three Adam steps on one batch (the
   loss must fall; 820 / 200 / 410 / 200 launches of conv / gate + skip /
   wgrad / CA backward each), ms/step, tiles/s, peak memory and idle share
   against the Winograd and direct trunks;
18. the conv kernel's scaled residual epilogue (res + res_scale·conv,
   res_scale 0.1 and 0.8, m ∈ {2, 4}, (72, 64, 48, 48)) against its twin,
   and at res_scale 1 the unscaled epilogue's bits; the conv chain
   (``wino_chain_fwd``, K = 20 convs + ReLU in one cooperative launch, m=4,
   bf16 and f32) against its twin, bit for bit against K ``wino_conv``
   launches, and timed in device time against them (U in the kernels'
   order), the twin and K ``F.conv2d`` + ReLU on channels_last weights,
   with its bound and a device-time profile;
19. one EDSR trunk (16 ResBlocks + body conv + skip, the ungated group,
   m=4, b72): forward, stash and gradients, kernels against twins (the rule
   of phase 8 for flipped gates; the backward kernels alone on one shared
   stash), timed against the direct cuDNN trunk of the same weights;
20. EDSR ×4 (config/model/edsr.yaml + ``winograd: 4``) served: three
   requests of 72 tiles, 33 ``wino_conv`` launches each, held against the
   plain twins, timed in turns against the same weights with ``winograd``
   unset, and profiled;
21. the same EDSR trained (Adam, lr 1e-4, b72): one step's loss and
   gradients against the plain twins, three Adam steps on one batch (the
   loss must fall; 49 ``wino_conv`` and 33 ``wino_conv_bwd`` launches
   each), ms/step, tiles/s, peak memory and idle share against the direct
   trunk, and a profile;
22. the window-attention forward and backward (the kernels of phases 10
   and 11) against their twins at SwinIR-w16's serving shape (432 windows
   of 256 tokens, C 64, 4 heads), unshifted and shifted (the 36-window
   group mask), timed against the composition; and at T = 16 (8 windows)
   and T = 144 (6 windows, head width 32, a cluster whose last CTA holds 16
   query rows), checked only;
23. SwinIR ×4 with 16×16 windows (config/model/swinir.yaml + ``window_size:
   16``) served as phase 12 serves window 8: three requests of 12 HR tiles,
   16 window_attention launches each, held against the plain twins, timed
   against the composition, profiled;
24. the same model trained as phase 13: one step's loss and gradients
   against the plain twins, three Adam steps (16 window_attention and 16
   window_attention_bwd launches each; the loss must fall), ms/step,
   tiles/s, peak memory, the composition, a profile;
25. the port's launcher (``sres_tpu_torch.train.main``: config reader,
   synthetic data pipeline, ModelTrainer, checkpoints, the loss CSV) on
   RCAN-10-20-64 ``winograd: 4``, bf16, config/task/synthetic-tiles-48.yaml
   (batch 36 of 48×48 LR tiles) over a 1920×1920 region of 10 timeslices,
   under a temporary platform.root: (a) one epoch: the CSV's rows (finite),
   both checkpoint slots, the kernels' launches (a train step's and an eval
   batch's counts times the trainer's), the first step's metrics bit for
   bit against build_train_step on the same padded batch and weights, the
   trainer's wall a step against build_train_step alone on the epoch's
   padded batches, the host's parts, validation time, peak memory and a
   torch.profiler capture of one timeslice (device time, idle share, its
   host-to-device copies); (b) the run resumed from its train checkpoint
   for one more epoch; (c) one epoch with ``pipeline.grad_accum=2`` and one
   with ``pipeline.steps_per_dispatch=2`` on 3 timeslices;
26. region serving: the same model served from phase 25's best-validation
   checkpoint through ``WorkflowController.inference`` and
   ``inference_stream`` (``task.xyflip`` as the task sets it; the serving
   paths turn it off). At 1920² HR (a 10×10 grid of 192-pixel tiles, 15 %
   land): ``infer_region`` (every grid slot in one padded batch, the mosaic
   assembled on the card), ``spatial`` (the active region as one 480×480 LR
   sample), ``Tiles`` (the validation timestep's tiles), ``Image`` tiled
   (``process_image``), ``seamless`` (margin 8: 52×52 LR tiles) and the
   stream over the validation and test timeslices. Each: the NaN holes where
   the region's are (the tiles with any NaN pixel in the tiled modes; the
   NaN pixels themselves in ``spatial``), the model panel finite wherever
   the target is, the target equal to the raw region (rtol 2e-4; the Tiles
   mode: each tile's lnorm of it), the NetCDF files read back as written,
   the launches (411 ``wino_conv`` and 200 ``ca_skip`` a forward), and the
   model panel held against the same run on the plain twins and the direct
   cuDNN trunk: in f32 the two within 1e-4·max, the kernels' bf16 within
   the envelope of the twins' bf16 and of cuDNN's; ``infer_region`` after
   ``update_model=True``
   equals a fresh model built from the checkpoint, bit for bit, though the
   seeded weights were served first; each slice of the stream equals
   ``infer_region`` of it, bit for bit, and the stream's wall is taken with
   one prep thread and with none, in turns, the loader's caches emptied
   before each. At 3840² (400 slots): ``infer_region`` and ``spatial``, and
   the first RCAB of the first group (rows 1 and 4) at one (1, 64, 960,
   960) sample against its twin. One line a mode: seconds a region, HR
   tiles/s (land-free tiles), device ms and idle share (torch.profiler, a
   second call), peak memory, the trainer's host timers, launches a
   region.

Phase 9's profile of a step fails on a copy from the host to the card
(the step's operands are on the card).

Tolerances: f32 max|kernel − plain| ≤ 3e-5·max|plain| (group 1e-4, and
1e-2 for a group's gradients when a ReLU gate flipped between the kernel
and twin forwards, a count the script prints); bf16
rel_err(kernel_bf16, plain_f32) ≤ 2·rel_err(plain_bf16, plain_f32) + 1e-4,
where rel_err(a, b) = max|a − b| / max|b| (the envelope logic of
tests/test_winograd.py:test_winograd_bf16_noise_envelope).

Bounds: ``bound_ms`` is the larger of the bytes a call must move (each
input read once, each output written once) over 3.35 TB/s and its tensor-
core products over 989 TFLOP/s (bf16), for the timed call's shapes.
``library_ms`` times one PyTorch call computing the same function where one
exists (cuDNN's conv and conv backward), and for window attention the
composition above; the port never calls them. For the direct-conv group
kernels ``bound_ms`` is that of the timed mode (the conv as conv1, the
weight gradient plain), each mode's time in ``modes``; their times and
library times are device times (``device_ms``: the stream is held while
the host queues the calls).

The last three lines are a JSON object describing every kernel of the path
(``launches`` counted over the three steps of each train slice, phases 9,
13, 17, 21 and 24; ``trainer_launches`` over phase 25a's epoch, EDSR's adding to RCAN's ``wino_conv`` and
``wino_conv_bwd``; the window attention listed once per main path and
direction: ``window_attention`` and ``window_attention_bwd`` at T = 64
with phase 13's launches and phase 10's and 11's times,
``window_attention_t256`` and ``window_attention_bwd_t256`` with phase
24's and phase 22's, each naming its CUDA kernels; ``wino_conv_bwd`` naming its three
kernels, with each mode's times in ``modes``; ``ca_skip`` naming its two
kernels, the cluster size at the flagship's shape and the two-pass
kernel's time at (2, 64, 192, 192); ``fgroup_ca`` naming its kernel, with
the serving and stash modes' times and bounds; ``ca_skip_bwd`` and
``fgroup_ca_bwd`` naming their kernels, each mode's time and bound in
``modes`` and ``mode_bound_ms``; ``serve_launches`` over the three
requests of phases 5, 12, 16, 20 and 23; ``region_launches`` over phase 26's
served calls, the comparisons' and the profiled repeats' left out; the
chain's over the one probe launch of phase 18), the card's
name and power limit, and ``{"ok": true, "device": {...}}``. Any failed
check exits non-zero before those lines are printed.
"""
from __future__ import annotations

import argparse
import json
import math
import platform
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# config/model/rcan-10-20-64.yaml, plus the Winograd trunk
MODEL_CFG = dict(name="rcan", nlayers=10, nblocks=20, nfeatures=64,
                 cbottleneck=2, loss_fn="l2", kernel_size=3, res_scale=1.0,
                 batch_norm=False, bias=True, downscale_factors=[2, 2],
                 ups_mode="bicubic", lane_pack=2, winograd=4)
# one single-variable SST task, as config/task/SST-tiles-48.yaml serves it
TASK_CFG = dict(input_variables=["SST"], target_variables=["SST"],
                downsample_mode="cubic", upsample_mode="cubic")
# config/task/SST-tiles-48.yaml's Adam lr
TRAIN_TASK = dict(TASK_CFG, lr=1e-4)
BATCH, HR, NREQ, NSTEP = 72, 192, 3, 3
SHAPE = (BATCH, 64, 48, 48)
# config/model/swinir.yaml; config/task/SST-tiles-96.yaml: 96×96 LR tiles
# (1×384×384 HR), batch 12, Adam lr 2e-4
SWIN_CFG = dict(name="swinir", nfeatures=64, nlayers=4, nblocks=4, window_size=8,
                num_heads=4, mlp_ratio=2.0, loss_fn="l2", kernel_size=3,
                downscale_factors=[2, 2], ups_mode="bicubic", fused_attention=True)
SWIN_TRAIN_TASK = dict(TASK_CFG, lr=2e-4)
SWIN_BATCH, TILE96 = 12, 96
SWIN_HR = 4 * TILE96
SWIN_NW = SWIN_BATCH * (TILE96 // SWIN_CFG["window_size"]) ** 2
# the same model with HAT's 16×16 windows (XPixelGroup/HAT, window_size: 16),
# set in code: T = 256, 432 windows at batch 12, 36 in a shifted group
SWIN16_CFG = dict(SWIN_CFG, window_size=16)
SWIN16_NW = SWIN_BATCH * (TILE96 // SWIN16_CFG["window_size"]) ** 2

F32_TOL, GROUP_F32_TOL = 3e-5, 1e-4
# one group's f32 gradients where a ReLU gate flipped between the kernel and
# twin forwards: twice the largest such reading, dx at 4.7e-3·max on the
# H100 (PERF.md §6); a wrong kernel misses it by orders of magnitude
FLIPPED_GRAD_F32_TOL = 1e-2
# H100 SXM data-sheet peaks: HBM bytes/s and dense bf16 tensor-core FLOP/s
HBM_BYTES_S, BF16_FLOP_S = 3.35e12, 989e12


class CheckFailed(RuntimeError):
    pass


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


CARD = ""


def say(phase: str, **kv) -> None:
    print(f"[{CARD}] {phase}: " + json.dumps(kv, default=float), flush=True)


def rel_err(a, ref) -> float:
    ref = ref.float()
    return float((a.float() - ref).abs().max() / ref.abs().max())


def check_pair(name, k32, p32, kbf, pbf, f32_tol=F32_TOL) -> dict:
    """f32 bound and bf16 envelope; raises CheckFailed on a miss."""
    import torch
    for t in (k32, p32, kbf, pbf):
        if not torch.isfinite(t.float()).all():
            raise CheckFailed(f"{name}: non-finite output")
    e32 = float((k32 - p32).abs().max())
    b32 = f32_tol * float(p32.abs().max())
    e_k, e_p = rel_err(kbf, p32), rel_err(pbf, p32)
    res = dict(case=name, f32_err=e32, f32_rel=e32 / max(float(p32.abs().max()), 1e-30),
               f32_bound=b32, bf16_kernel_rel=e_k,
               bf16_plain_rel=e_p, bf16_bound=2 * e_p + 1e-4,
               bf16_vs_plain_abs=float((kbf.float() - pbf.float()).abs().max()))
    if not (e32 <= b32 and e_k <= 2 * e_p + 1e-4):
        raise CheckFailed(f"{name}: {res}")
    return res


def bound_ms(nbytes: float, flops: float) -> float:
    """Least time for the work: bytes over HBM rate vs products over peak."""
    return 1e3 * max(nbytes / HBM_BYTES_S, flops / BF16_FLOP_S)


def bound_by(nbytes: float, flops: float) -> str:
    """Which of the two bounds ``bound_ms`` takes."""
    return "bytes" if nbytes / HBM_BYTES_S >= flops / BF16_FLOP_S else "operations"


def tap_flops(shape, m: int) -> float:
    """FLOP of one conv's n² tap products: (tiles × C) @ (C × C) per tap."""
    t, c, h, w = shape
    return 2.0 * (m + 2) ** 2 * t * (h // m) * (w // m) * c * c


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device ms per call over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


# about 25 ms of a held stream at the H100's clock: longer than the host
# takes to queue a timed run of wrapper calls
SLEEP_CYCLES = 50_000_000


def device_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device ms per call: ``torch.cuda._sleep`` holds the stream while
    the host queues the ``iters`` calls, so the CUDA events time the
    device's work and not the wrapper's host cost (``time_ms`` times calls
    back to back, and so includes it for kernels shorter than the wrapper)."""
    import torch
    for _ in range(warmup):
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


def smooth_fields(rng: np.random.Generator, n: int, size: int,
                  ncomp: int = 8) -> np.ndarray:
    """(n, 1, size, size) f32 smooth multi-scale sinusoid fields: the recipe
    of sres_tpu/data/synthetic.py:_field, one field per tile at t = index."""
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    out = np.zeros((n, 1, size, size), np.float32)
    for i in range(n):
        for _ in range(ncomp):
            fy, fx = rng.uniform(1, 12, 2)
            phase = rng.uniform(0, 2 * np.pi) + i * rng.uniform(0.1, 1.0)
            amp = rng.uniform(0.2, 1.0)
            out[i, 0] += (amp * np.sin(2 * np.pi * (fy * yy + fx * xx) + phase)
                          ).astype(np.float32)
    return out


def profile_device(label, fn, top: int = 12, no_htod: bool = False) -> float:
    """Device time by kernel name for one call of ``fn`` (torch.profiler,
    CUPTI); prints the table, with the host-to-device copies apart, and
    returns the device-busy ms. ``no_htod``: raise if ``fn`` copied from
    the host to the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # device-side events only: a CPU op's device time repeats its kernels'
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    htod = [dict(copy=k, ms=ms, calls=n) for k, ms, n in rows if k.startswith("Memcpy HtoD")]
    say(label, device_ms_total=total, htod=htod,
        top=[dict(kernel=k[:90], ms=ms, calls=n) for k, ms, n in rows[:top]])
    if no_htod and htod:
        raise CheckFailed(f"{label}: host-to-device copies inside the call: {htod}")
    return total


def short_name(mangled: str) -> str:
    """A kernel's mangled name shortened to its last nested name and the
    start of its template arguments (``fg_conv_wgmma_kernelILb0ELb1ELb0``)."""
    i, last = mangled.find("_ZN") + 3, ""
    if i < 3:
        return mangled[:60]
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        last, i = mangled[j:j + n], j + n
    return last + mangled[i:i + 12] if last else mangled[:60]


# --------------------------------------------------------------- phases
def phase_toolchain():
    import torch
    from sres_tpu_torch.ops import cuda
    nvcc = cuda.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    cuda.load()
    # each kernel's registers and spills, under a short form of its name
    ptxas, name = [], ""
    for ln in cuda.build_log.splitlines():
        if "Compiling entry function" in ln:
            name = short_name(ln.split("'")[1])
        elif "registers" in ln or "spill" in ln:
            ptxas.append(f"{name}: {ln.strip()}")
    say("1 toolchain", python=platform.python_version(), torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=ver, ninja=shutil.which("ninja"),
        build_s=cuda.build_seconds, load_s=time.perf_counter() - t0,
        ptxas=ptxas)
    return cuda.build_seconds


def phase_conv(dev, rng):
    import torch
    import torch.nn.functional as F
    from sres_tpu_torch.ops.winograd import transform_weights
    from sres_tpu_torch.ops.winograd_conv import kernel_u, wino_conv, wino_conv_plain
    c = SHAPE[1]
    # channels_last: the memory format the model's trunk hands the kernels
    cl = dict(memory_format=torch.channels_last)
    x = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32)).to(dev).contiguous(**cl)
    res = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32)).to(dev).contiguous(**cl)
    bound = 1 / math.sqrt(9 * c)
    w = torch.from_numpy(rng.uniform(-bound, bound, (c, c, 3, 3)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(-bound, bound, c).astype(np.float32)).to(dev)
    xb, resb = x.bfloat16(), res.bfloat16()
    worst = 0.0
    for m in (2, 4):
        u = transform_weights(w, m)
        for relu in (False, True):
            for r32, rbf in ((None, None), (res, resb)):
                name = f"m{m}{'_relu' if relu else ''}{'_res' if r32 is not None else ''}"
                out = check_pair(
                    name,
                    wino_conv(x, u, b, m, relu, r32), wino_conv_plain(x, u, b, m, relu, r32),
                    wino_conv(xb, u, b, m, relu, rbf), wino_conv_plain(xb, u, b, m, relu, rbf))
                torch.cuda.synchronize()
                say("2 kernel wino_conv", **out)
                if m == 4:
                    worst = max(worst, out["bf16_vs_plain_abs"])
    # U as the module caches keep it: the kernels' order, built once
    ku = {m: kernel_u(transform_weights(w, m).bfloat16()) for m in (2, 4)}
    for m in (2, 4):
        if not torch.equal(wino_conv(xb, ku[m], b, m, True),
                           wino_conv(xb, transform_weights(w, m), b, m, True)):
            raise CheckFailed(f"kernel-order U changed the conv's bits (m{m})")
    u4 = ku[4]
    modes = {"relu": lambda: wino_conv(xb, u4, b, 4, True),
             "bias": lambda: wino_conv(xb, u4, b, 4),
             "residual": lambda: wino_conv(xb, u4, b, 4, residual=resb),
             "scaled": lambda: wino_conv(xb, u4, b, 4, residual=resb, res_scale=0.1),
             "m2_relu": lambda: wino_conv(xb, ku[2], b, 2, True)}
    dms = {k: device_ms(f) for k, f in modes.items()}
    events_ms = time_ms(modes["relu"])
    plain_ms = device_ms(lambda: wino_conv_plain(xb, u4.u, b, 4, True), iters=3)
    ms_f32 = device_ms(lambda: wino_conv(x, u4.u.float(), b, 4, True))
    # cuDNN with channels_last bf16 weights and a bf16 bias, in device time
    wb = w.bfloat16().contiguous(**cl)
    bb = b.bfloat16()
    library_ms = device_ms(lambda: F.conv2d(xb, wb, bb, padding=1))
    library_events_ms = time_ms(lambda: F.conv2d(xb, wb, bb, padding=1))
    # x read, y written (bf16), U (bf16) and the f32 bias read; the scaled
    # and residual modes also read res
    nb = 2 * 2 * xb.numel() + 2 * u4.u.numel() + 4 * c
    bound = bound_ms(nb, tap_flops(SHAPE, 4))
    bounds = dict(relu=bound, bias=bound, residual=bound_ms(nb + 2 * xb.numel(),
                                                            tap_flops(SHAPE, 4)),
                  scaled=bound_ms(nb + 2 * xb.numel(), tap_flops(SHAPE, 4)),
                  m2_relu=bound_ms(2 * 2 * xb.numel() + 2 * ku[2].u.numel() + 4 * c,
                                   tap_flops(SHAPE, 2)))
    say("2 kernel wino_conv timing", shape=SHAPE, m=4, dtype="bf16", device_ms=dms,
        events_ms=events_ms, plain_ms=plain_ms, f32_ms=ms_f32, bound_ms=bounds,
        library_ms_cudnn_conv2d_bias=library_ms, library_events_ms=library_events_ms)
    return dict(max_abs_err=worst, ms=dms["relu"], plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by(nb, tap_flops(SHAPE, 4)), library_ms=library_ms,
                modes=dms, mode_bound_ms=bounds, kernels=["wino_conv_wgmma_kernel"])


def phase_ca(dev, rng):
    import torch
    from sres_tpu_torch.ops import cuda
    from sres_tpu_torch.ops.winograd_conv import ca_skip, ca_skip_plain
    c, hid = SHAPE[1], SHAPE[1] // MODEL_CFG["cbottleneck"]
    cl = dict(memory_format=torch.channels_last)
    lib = cuda.load()
    ws = [torch.from_numpy(rng.uniform(-a, a, s).astype(np.float32)).to(dev)
          for a, s in ((1 / 8, (hid, c)), (1 / 8, (hid,)),
                       (1 / math.sqrt(hid), (c, hid)), (1 / math.sqrt(hid), (c,)))]
    # the flagship's shape (the cluster kernel) and samples too large for a
    # cluster (the two-pass kernel)
    worst, routes = 0.0, {}
    for shape in (SHAPE, (2, c, 192, 192)):
        q = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev).contiguous(**cl)
        r = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
             + 0.3).contiguous(**cl)
        qb, rb = q.bfloat16(), r.bfloat16()
        out = check_pair(f"ca_skip {shape}", ca_skip(q, r, *ws), ca_skip_plain(q, r, *ws),
                         ca_skip(qb, rb, *ws), ca_skip_plain(qb, rb, *ws))
        torch.cuda.synchronize()
        routes[str(shape)] = {dt: lib.sres_ca_skip_cluster(shape[0], shape[2] * shape[3], bf, 0)
                              for dt, bf in (("bf16", 1), ("f32", 0))}
        say("3 kernel ca_skip", cluster=routes[str(shape)], **out)
        if shape == SHAPE:
            worst = out["bf16_vs_plain_abs"]
            ms = device_ms(lambda: ca_skip(qb, rb, *ws))
            events = time_ms(lambda: ca_skip(qb, rb, *ws))
            plain_ms = device_ms(lambda: ca_skip_plain(qb, rb, *ws))
        else:
            two_pass_ms = device_ms(lambda: ca_skip(qb, rb, *ws))
            two_pass_bound = bound_ms(3 * 2 * qb.numel(), 0.0)
    # q and r read, out written (bf16); the MLP's few thousand MACs
    bound = bound_ms(3 * 2 * SHAPE[0] * SHAPE[1] * SHAPE[2] * SHAPE[3], 0.0)
    say("3 kernel ca_skip timing", shape=SHAPE, dtype="bf16", device_ms=ms, events_ms=events,
        plain_ms=plain_ms, bound_ms=bound, two_pass_shape=(2, c, 192, 192),
        two_pass_device_ms=two_pass_ms, two_pass_bound_ms=two_pass_bound)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes",
                library_ms=None, kernels=["ca_cluster_kernel", "ca_two_pass_kernel"],
                cluster=routes[str(SHAPE)]["bf16"], two_pass_ms=two_pass_ms,
                two_pass_bound_ms=two_pass_bound)


def phase_group(dev, seed):
    import torch
    from sres_tpu_torch.models.wino_blocks import WinoResidualGroup
    from sres_tpu_torch.models.layers import init_torch_default
    g = init_torch_default(WinoResidualGroup(64, MODEL_CFG["cbottleneck"],
                                             MODEL_CFG["nblocks"], 4), seed).to(dev)
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=SHAPE)
                         .astype(np.float32)).to(dev)
    outs = {}
    with torch.inference_mode():
        for plain in (False, True):
            g.plain = plain
            for dt in (torch.float32, torch.bfloat16):
                outs[(plain, dt)] = g(x.to(dt))
        torch.cuda.synchronize()
        out = check_pair("group nb=20 m=4 +trail", outs[(False, torch.float32)],
                         outs[(True, torch.float32)], outs[(False, torch.bfloat16)],
                         outs[(True, torch.bfloat16)], GROUP_F32_TOL)
        say("4 group", **out)
        xb = x.bfloat16()
        ms = {}
        for plain in (False, True):
            g.plain = plain
            ms[plain] = time_ms(lambda: g(xb), iters=3, warmup=1)
        g.plain = False
    say("4 group timing", dtype="bf16", ms=ms[False], plain_ms=ms[True])


def phase_slice(dev, seed):
    import torch
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import set_plain_twins
    from sres_tpu_torch.ops import winograd_conv as wc
    from sres_tpu_torch.trainer.step import build_eval_step, make_step_config

    model = build_model(MODEL_CFG, 1, 1, precision="bf16", seed=seed, device=dev)
    sc = make_step_config(TASK_CFG, MODEL_CFG)
    eval_step = build_eval_step(model, sc)
    rng = np.random.default_rng(seed)
    reqs = [torch.from_numpy(smooth_fields(rng, BATCH, HR)).to(dev)
            for _ in range(NREQ)]
    weight = torch.ones(BATCH, device=dev)
    eval_step(reqs[0], weight)                 # builds the U caches
    torch.cuda.synchronize()

    wc.reset_launches()
    results = [eval_step(hr, weight) for hr in reqs]
    torch.cuda.synchronize()
    launches = dict(wc.LAUNCHES)
    for i, (met, (lr, out, tar, interp)) in enumerate(results):
        s, si = float(met["sloss"]), float(met["interp_sloss"])
        ok = (math.isfinite(s) and math.isfinite(si) and si > 0
              and tuple(out.shape) == (BATCH, 1, HR, HR)
              and bool(torch.isfinite(out).all()))
        say("5 slice request", request=i, sloss=s, interp_sloss=si,
            ratio_pct=100.0 * s / si, out_shape=list(out.shape))
        if not ok:
            raise CheckFailed(f"request {i}: non-finite or misshapen output")
    nl, nb = MODEL_CFG["nlayers"], MODEL_CFG["nblocks"]
    want = {"wino_conv": NREQ * (nl * (2 * nb + 1) + 1), "ca_skip": NREQ * nl * nb,
            "wino_conv_bwd": 0, "ca_skip_bwd": 0, "wino_chain": 0}
    say("5 slice launches", launches=launches, expected=want)
    if launches != want:
        raise CheckFailed(f"kernel launches {launches} != expected {want}")

    # the same request through the plain twins (bf16), and the f32 truth
    out_k = results[0][1][1]
    set_plain_twins(model, True)
    out_p = eval_step(reqs[0], weight)[1][1]
    ref = build_model(MODEL_CFG, 1, 1, precision="f32", device=dev)
    ref.load_state_dict(model.state_dict())
    set_plain_twins(ref, True)
    out_t = build_eval_step(ref, sc)(reqs[0], weight)[1][1]
    e_k, e_p = rel_err(out_k, out_t), rel_err(out_p, out_t)
    say("5 slice vs plain", bf16_kernel_rel=e_k, bf16_plain_rel=e_p,
        bound=2 * e_p + 1e-4,
        kernel_vs_plain_abs=float((out_k - out_p).abs().max()))
    if not e_k <= 2 * e_p + 1e-4:
        raise CheckFailed(f"slice output outside the bf16 envelope: {e_k} > 2*{e_p}+1e-4")
    del ref

    # timing: the kernel path, the same model on the plain twins, and the
    # same weights on the direct (cuDNN) trunk, in turns
    direct = build_model(dict(MODEL_CFG, winograd=None), 1, 1, "bf16", device=dev)
    direct.load_state_dict(model.state_dict())
    steps = {"kernel": eval_step, "plain": eval_step,
             "direct": build_eval_step(direct, sc)}

    def window(name):
        set_plain_twins(model, name == "plain")
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for hr in reqs:
            steps[name](hr, weight)
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    timing = {}
    for name in ("kernel", "plain", "direct", "direct", "plain", "kernel"):
        window(name)                              # warm-up
        timing.setdefault(name, []).extend(window(name) for _ in range(3))
    set_plain_twins(model, False)
    for name, ws in timing.items():
        med = statistics.median(ws)
        say(f"5 slice timing {name}", windows_ms=ws, median_ms=med,
            ms_per_request=med / NREQ, tiles_per_s=NREQ * BATCH / (med / 1e3))
    say("5 slice memory", peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    for name in ("kernel", "direct"):
        profile_device(f"5 slice profile {name}",
                       lambda: steps[name](reqs[0], weight))
    return launches


def _rand(rng, dev, shape, scale=1.0, shift=0.0):
    import torch
    a = torch.from_numpy((rng.normal(size=shape) * scale + shift).astype(np.float32))
    a = a.to(dev)
    return a.contiguous(memory_format=torch.channels_last) if a.dim() == 4 else a


# the conv adjoint's modes: (cotangent dtype is f32, ReLU gate, CA prologue,
# added into an f32 dprev); "adjoint" takes g in the activation dtype
BWD_MODES = {"adjoint": (False, False, False, False), "f32g": (True, False, False, False),
             "relu": (False, True, False, False), "ca": (True, False, True, False),
             "accum": (True, True, False, True)}
# the CUDA kernels behind one wino_conv_bwd call
WINO_BWD_KERNELS = ["wino_bwd_dx_kernel", "wino_bwd_du_kernel", "wino_bwd_sum_kernel"]


def phase_conv_bwd(dev, rng):
    import torch
    from sres_tpu_torch.ops.winograd import transform_weights
    from sres_tpu_torch.ops.winograd_conv import (wino_conv_bwd, wino_conv_bwd_plain,
                                                  wino_conv_plain)
    f32, bf16 = torch.float32, torch.bfloat16
    c = SHAPE[1]
    x, g, prev = _rand(rng, dev, SHAPE), _rand(rng, dev, SHAPE), _rand(rng, dev, SHAPE)
    bound = 1 / math.sqrt(9 * c)
    w = torch.from_numpy(rng.uniform(-bound, bound, (c, c, 3, 3)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(-bound, bound, c).astype(np.float32)).to(dev)
    gate, ds = _rand(rng, dev, (BATCH, c)).sigmoid(), _rand(rng, dev, (BATCH, c), 1e-3)
    worst, ys = 0.0, {}

    def call(fn, mode, m, u, dt):
        g32, relu, ca, acc = BWD_MODES[mode]
        kw = {}
        if relu:
            kw["y"] = ys[m].to(dt)
        if ca:
            kw.update(gate=gate, ds=ds)
        if acc:
            kw["dprev"] = prev.clone()
        return fn(g if g32 else g.to(dt), x.to(dt), u, m, **kw)

    for m in (2, 4):
        u = transform_weights(w, m)
        ys[m] = wino_conv_plain(x, u, b, m, relu=True)      # a ReLU output to gate by
        for mode in BWD_MODES:
            outs = [call(fn, mode, m, u, dt) for fn, dt in (
                (wino_conv_bwd, f32), (wino_conv_bwd_plain, f32),
                (wino_conv_bwd, bf16), (wino_conv_bwd_plain, bf16))]
            torch.cuda.synchronize()
            for i, name in enumerate(("dx", "dU", "db")):
                out = check_pair(f"m{m}_{mode}_{name}", *(o[i] for o in outs))
                say("6 kernel wino_conv_bwd", **out)
                if m == 4:
                    worst = max(worst, out["bf16_vs_plain_abs"])
            del outs
    u4 = transform_weights(w, 4).bfloat16()
    xb, gb, wb = x.bfloat16(), g.bfloat16(), w.bfloat16()
    # two calls give the same bits (fixed-order sums, no atomics)
    d1, d2 = (call(wino_conv_bwd, "accum", 4, u4, bf16) for _ in range(2))
    torch.cuda.synchronize()
    if not all(torch.equal(p1, p2) for p1, p2 in zip(d1, d2)):
        raise CheckFailed("wino_conv_bwd: two calls gave different bits")
    del d1, d2
    library_ms = time_ms(lambda: torch.ops.aten.convolution_backward(
        gb, xb, wb, [c], [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, True]))
    n = xb.numel()
    flops = 2 * tap_flops(SHAPE, 4)                         # dV and dU products
    # bytes per element of the activation tensors: each input read once,
    # each output written once (bf16 2, f32 4); plus U read (bf16) and dU,
    # db written (f32)
    per_elem = {"adjoint": 2 + 2 + 2, "f32g": 4 + 2 + 4, "relu": 2 + 2 + 2 + 2,
                "ca": 4 + 2 + 4, "accum": 4 + 2 + 2 + 4 + 4}
    modes = {}
    acc, yb = prev.clone(), ys[4].bfloat16()
    # operands converted once, outside the timed calls
    timed = {"relu": (gb, dict(y=yb)), "ca": (g, dict(gate=gate, ds=ds)),
             "accum": (g, dict(y=yb, dprev=acc)), "f32g": (g, {})}
    for mode, (gg, kw) in timed.items():
        nbytes = per_elem[mode] * n + 2 * u4.numel() + 4 * (u4.numel() + c)
        ms = time_ms(lambda: wino_conv_bwd(gg, xb, u4, 4, **kw))
        modes[mode] = dict(ms=ms, bound_ms=bound_ms(nbytes, flops),
                           bound_by=bound_by(nbytes, flops), library_ms=library_ms)
    plain_ms = time_ms(lambda: wino_conv_bwd_plain(gb, xb, u4, 4, y=yb), iters=3, warmup=1)
    say("6 kernel wino_conv_bwd timing", shape=SHAPE, m=4, dtype="bf16", kernels=WINO_BWD_KERNELS,
        plain_ms_relu=plain_ms, library_ms_cudnn_convolution_backward=library_ms,
        deterministic=True, **{f"{k}_{q}": v for k, d in modes.items() for q, v in d.items()})
    profile_device("6 kernel wino_conv_bwd profile relu",
                   lambda: wino_conv_bwd(gb, xb, u4, 4, y=yb))
    head = modes["relu"]
    return dict(max_abs_err=worst, ms=head["ms"], plain_ms=plain_ms, bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=library_ms, kernels=WINO_BWD_KERNELS,
                modes=modes)


# the channel-attention backwards' extra shapes: samples too large for one
# block, and an odd pixel count (117) with fewer pixels than blocks
CA_LARGE, CA_ODD = (2, 64, 192, 192), (3, 64, 9, 13)


def one_kernel(label, fn, name) -> None:
    """One call of ``fn`` (its operands already prepared) is one device
    kernel whose name holds ``name``, by torch.profiler's device rows; raises
    otherwise. The capture holds the call between 64 launches of a marker
    kernel (``torch.cuda._sleep``, named ``spin_kernel``) on each side: after
    the SwinIR phases the H100's captures lost their first few device
    records (5 of 129), so a capture of one short launch alone came back
    with no device rows at all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1)
        fn()
        for _ in range(64):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    rows = [(e.key, e.count) for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    markers = sum(n for k, n in rows if "spin_kernel" in k)
    kernels = [(k, n) for k, n in rows if "spin_kernel" not in k]
    say(label, device_kernels=[(k[:80], n) for k, n in kernels], markers=markers)
    if markers < 64 or len(kernels) != 1 or kernels[0][1] != 1 or name not in kernels[0][0]:
        raise CheckFailed(f"{label}: expected one {name} launch between 64 + 64 markers, "
                          f"got {kernels} and {markers} markers")


def phase_ca_bwd(dev, rng):
    """Phase 7: ca_skip_bwd (one cooperative launch, ca_skip_bwd_kernel)
    against its twin at the flagship's shape, at samples too large for a
    block and at an odd pixel count; the same bits on two calls; one kernel
    a call; device time and events beside each mode's bound."""
    import torch
    from sres_tpu_torch.ops.winograd_conv import ca_skip_bwd, ca_skip_bwd_plain
    c, hid = SHAPE[1], SHAPE[1] // MODEL_CFG["cbottleneck"]
    ws = [torch.from_numpy(rng.uniform(-a, a, s).astype(np.float32)).to(dev)
          for a, s in ((1 / 8, (hid, c)), (1 / 8, (hid,)),
                       (1 / math.sqrt(hid), (c, hid)), (1 / math.sqrt(hid), (c,)))]
    worst, ops = 0.0, {}
    for shape in (SHAPE, CA_LARGE, CA_ODD):
        da, c2 = _rand(rng, dev, shape), _rand(rng, dev, shape, shift=0.3)
        c2b = c2.bfloat16()
        outs = [fn(da, cc, *ws) for fn, cc in ((ca_skip_bwd, c2), (ca_skip_bwd_plain, c2),
                                               (ca_skip_bwd, c2b), (ca_skip_bwd_plain, c2b))]
        torch.cuda.synchronize()
        for i, name in enumerate(("gate", "ds", "dcaw1", "dcab1", "dcaw2", "dcab2")):
            out = check_pair(f"ca_skip_bwd_{name} {shape}", *(o[i] for o in outs))
            say("7 kernel ca_skip_bwd", **out)
            if shape == SHAPE:
                worst = max(worst, out["bf16_vs_plain_abs"])
        for cc in (c2, c2b):
            again = ca_skip_bwd(da, cc, *ws)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs[0 if cc is c2 else 2], again)):
                raise CheckFailed(f"ca_skip_bwd {shape} {cc.dtype}: two calls differ")
        ops[shape] = (da, c2, c2b)
        del outs
    da, c2, c2b = ops[SHAPE]
    one_kernel("7 kernel ca_skip_bwd launch", lambda: ca_skip_bwd(da, c2b, *ws),
               "ca_skip_bwd_kernel")
    # da (f32) and c2 read once; the per-sample outputs are 37 KB
    modes = {"bf16": (lambda: ca_skip_bwd(da, c2b, *ws), 6 * da.numel()),
             "f32": (lambda: ca_skip_bwd(da, c2, *ws), 8 * da.numel())}
    dal, _, c2bl = ops[CA_LARGE]
    modes["bf16 " + "x".join(map(str, CA_LARGE))] = (lambda: ca_skip_bwd(dal, c2bl, *ws),
                                                     6 * dal.numel())
    t = {k: device_ms(f) for k, (f, _) in modes.items()}
    t_events = {k: time_ms(f) for k, (f, _) in modes.items()}
    bounds = {k: bound_ms(b, 0.0) for k, (_, b) in modes.items()}
    plain_ms = device_ms(lambda: ca_skip_bwd_plain(da, c2b, *ws))
    say("7 kernel ca_skip_bwd timing", shape=SHAPE, device_ms=t, events_ms=t_events,
        bound_ms=bounds, plain_ms=plain_ms)
    return dict(max_abs_err=worst, ms=t["bf16"], plain_ms=plain_ms, bound_ms=bounds["bf16"],
                bound_by="bytes", library_ms=None, kernels=["ca_skip_bwd_kernel"], modes=t,
                mode_bound_ms=bounds)


def _cat(ts):
    import torch
    return torch.cat([t.detach().float().flatten() for t in ts])


def phase_group_bwd(dev, seed):
    import torch
    from sres_tpu_torch.models.layers import init_torch_default
    from sres_tpu_torch.models.wino_blocks import WinoResidualGroup
    from sres_tpu_torch.ops.winograd_conv import (wino_conv, wino_conv_plain,
                                                  wino_group_bwd, wino_group_bwd_plain,
                                                  wino_group_fwd, wino_group_fwd_plain)
    f32, bf16 = torch.float32, torch.bfloat16
    nb = MODEL_CFG["nblocks"]
    grp = init_torch_default(WinoResidualGroup(64, MODEL_CFG["cbottleneck"], nb, 4),
                             seed).to(dev)
    rng = np.random.default_rng(seed + 1)
    x, gy = _rand(rng, dev, SHAPE), _rand(rng, dev, SHAPE)
    names = [n for n, _ in grp.named_parameters()]
    kinds = {"conv_w": lambda n: n.endswith("weight") and "conv_du" not in n,
             "conv_b": lambda n: n.endswith("bias") and "conv_du" not in n,
             "ca": lambda n: "conv_du" in n}

    def grads(plain, dt):
        grp.plain = plain
        xx = x.to(dt).detach().requires_grad_()
        gs = torch.autograd.grad((grp(xx).float() * gy).sum(), [xx, *grp.parameters()])
        out = {"dx": gs[0].float()}
        for kind, sel in kinds.items():
            out[kind] = _cat(g for n, g in zip(names, gs[1:]) if sel(n))
        return out

    # the stash, kernels against twins; in f32 also the ReLU gates of the
    # RCABs' first convs that open on one side and not the other
    stashes, flips = {}, 0
    with torch.no_grad():
        for plain in (False, True):
            for dt in (f32, bf16):
                ws, bv, cw1, cb1, cw2, cb2, wt, bt = grp._operands(dt)
                st = []
                (wino_group_fwd_plain if plain else wino_group_fwd)(
                    x.to(dt), ws, bv, cw1, cb1, cw2, cb2, 4, wt, bt, st)
                stashes[(plain, dt)] = st
        ws, bv = grp._operands(f32)[:2]
        for k in range(nb):
            pre_k = wino_conv(stashes[(False, f32)][k], ws[k, 0], bv[k, 0], 4)
            pre_p = wino_conv_plain(stashes[(True, f32)][k], ws[k, 0], bv[k, 0], 4)
            flips += int(((pre_k > 0) != (pre_p > 0)).sum())
        torch.cuda.synchronize()
        out = check_pair("group stash", *(_cat(stashes[k]) for k in (
            (False, f32), (True, f32), (False, bf16), (True, bf16))), GROUP_F32_TOL)
    say("8 group stash", slots=nb + 1, relu_gates=nb * x.numel(), flipped_gates=flips,
        **out)
    del stashes
    # end to end under autograd: the bf16 envelope, and in f32 the group
    # bound, which a flipped gate widens: the m=4 backward carries the full
    # cotangent through a flip (sres_tpu/ops/winograd.py:244-252 measured
    # the same, 6e-3 relative), so with flips the f32 bound is
    # FLIPPED_GRAD_F32_TOL
    tol = GROUP_F32_TOL if flips == 0 else FLIPPED_GRAD_F32_TOL
    res = {(p, dt): grads(p, dt) for p in (False, True) for dt in (f32, bf16)}
    torch.cuda.synchronize()
    for kind in ("dx", *kinds):
        out = check_pair(f"group grad {kind}", *(res[k][kind] for k in (
            (False, f32), (True, f32), (False, bf16), (True, bf16))), tol)
        say("8 group backward", flipped_gates=flips, **out)
    del res
    # the backward kernels alone, in f32: kernels and twins from one stash,
    # recomputing with the same conv kernel, within 1e-4·max
    with torch.no_grad():
        ops = grp._operands(f32)
        st = []
        wino_group_fwd(x, *ops[:6], 4, ops[6], ops[7], st)
        rk = wino_group_bwd(gy, st, *ops[:6], 4, ops[6])
        rp = wino_group_bwd_plain(gy, st, *ops[:6], 4, ops[6], conv=wino_conv)
        torch.cuda.synchronize()
        del st
    for name, a, b in zip(("dx", "dU", "db", "dcaw1", "dcab1", "dcaw2", "dcab2",
                           "dUt", "dbt"), rk, rp):
        err, bound = float((a - b).abs().max()), GROUP_F32_TOL * float(b.abs().max())
        say("8 group backward kernels, same forward", grad=name, f32_err=err,
            f32_bound=bound)
        if not err <= bound:
            raise CheckFailed(f"group backward {name}: {err} > {bound}")
    del rk, rp
    ms = {}
    for plain in (False, True):
        grp.plain = plain
        xb = x.bfloat16().requires_grad_()
        ms[plain] = time_ms(lambda: torch.autograd.grad(
            (grp(xb).float() * gy).sum(), [xb, *grp.parameters()]), iters=2, warmup=1)
    grp.plain = False
    say("8 group backward timing", dtype="bf16", fwd_bwd_ms=ms[False],
        plain_fwd_bwd_ms=ms[True])


def _loss_and_grads(model, sc, hr, weight):
    """One step's mloss and parameter gradients, without the update."""
    from sres_tpu_torch.trainer.losses import sr_loss
    from sres_tpu_torch.trainer.step import prepare_inputs
    model.train()
    model.zero_grad(set_to_none=True)
    lr, target = prepare_inputs(hr, sc)
    _, mloss = sr_loss(model(lr), target, weight, sc.loss_fn)
    mloss.backward()
    grads = {n: p.grad.detach().float().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return mloss.detach().reshape(1).float(), grads


def phase_train(dev, seed):
    import torch
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import set_plain_twins
    from sres_tpu_torch.ops import winograd_conv as wc
    from sres_tpu_torch.ops.winograd import transform_weights
    from sres_tpu_torch.ops.winograd_conv import conv_order
    from sres_tpu_torch.trainer.step import (build_optimizer, build_train_step,
                                             make_step_config)
    nl, nb = MODEL_CFG["nlayers"], MODEL_CFG["nblocks"]
    model = build_model(MODEL_CFG, 1, 1, "bf16", seed=seed, device="cuda")
    sc = make_step_config(TASK_CFG, MODEL_CFG)
    rng = np.random.default_rng(seed + 2)
    batches = [torch.from_numpy(smooth_fields(rng, BATCH, HR)).to(dev) for _ in range(NSTEP)]
    weight = torch.ones(BATCH, device=dev)

    # one step's loss and gradients: kernels (bf16) and plain twins (bf16)
    # against the plain twins in f32, per residual group and the rest
    ref = build_model(MODEL_CFG, 1, 1, "f32", device="cuda")
    ref.load_state_dict(model.state_dict())
    set_plain_twins(ref, True)
    lt, gt = _loss_and_grads(ref, sc, batches[0], weight)
    del ref
    lk, gk = _loss_and_grads(model, sc, batches[0], weight)
    set_plain_twins(model, True)
    lp, gp = _loss_and_grads(model, sc, batches[0], weight)
    set_plain_twins(model, False)
    torch.cuda.synchronize()
    parts = {f"group{g}": f"body.{g}." for g in range(nl)}
    parts["loss"] = None
    for part, prefix in parts.items():
        if prefix is None:
            k, p, t = lk, lp, lt
        else:
            sel = lambda gd: _cat(v for n, v in gd.items() if n.startswith(prefix))
            k, p, t = sel(gk), sel(gp), sel(gt)
        for v in (k, p, t):
            if not torch.isfinite(v).all():
                raise CheckFailed(f"train {part}: non-finite gradient")
        e_k, e_p = rel_err(k, t), rel_err(p, t)
        say("9 train step vs plain", part=part, bf16_kernel_rel=e_k, bf16_plain_rel=e_p,
            bound=2 * e_p + 1e-4)
        if not e_k <= 2 * e_p + 1e-4:
            raise CheckFailed(f"train {part}: outside the bf16 envelope {e_k} > 2*{e_p}+1e-4")
    rest = [n for n in gk if not n.startswith("body.") or n.startswith(f"body.{nl}.")]
    e_k = rel_err(_cat(gk[n] for n in rest), _cat(gt[n] for n in rest))
    e_p = rel_err(_cat(gp[n] for n in rest), _cat(gt[n] for n in rest))
    say("9 train step vs plain", part="head, body conv, tail", bf16_kernel_rel=e_k,
        bf16_plain_rel=e_p, bound=2 * e_p + 1e-4)
    if not e_k <= 2 * e_p + 1e-4:
        raise CheckFailed(f"train rest: outside the bf16 envelope {e_k} > 2*{e_p}+1e-4")
    del gk, gp, gt

    # Adam steps on the kernel path, with launch counts per step
    step = build_train_step(model, build_optimizer(model, TRAIN_TASK), sc)
    body_conv = model.body[-1]
    w_before = body_conv.weight.detach().clone()
    # forward: 2 convs per RCAB, a trailing conv per group, the body conv;
    # backward: every conv's adjoint, and the 2 convs of each RCAB again
    nconv = nl * (2 * nb + 1) + 1
    want = {"wino_conv": nconv + 2 * nl * nb, "ca_skip": nl * nb,
            "wino_conv_bwd": nconv, "ca_skip_bwd": nl * nb, "wino_chain": 0}
    torch.cuda.reset_peak_memory_stats(dev)
    total = dict.fromkeys(want, 0)
    for i, hr in enumerate(batches):
        wc.reset_launches()
        met = step(hr, weight)
        torch.cuda.synchronize()
        launches = dict(wc.LAUNCHES)
        vals = {k: float(v) for k, v in met.items()}
        say("9 train step", step=i, **vals, launches=launches, expected=want)
        if not all(math.isfinite(v) for v in vals.values()):
            raise CheckFailed(f"train step {i}: non-finite metrics {vals}")
        if launches != want:
            raise CheckFailed(f"train step {i}: launches {launches} != {want}")
        for k in total:
            total[k] += launches[k]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    with torch.no_grad():
        u_now = transform_weights(body_conv.weight, 4).bfloat16()
        ku = body_conv._u(torch.bfloat16, kernel=True)    # the kernels' cache
        fresh = torch.equal(ku.u, u_now) and torch.equal(ku.fwd, conv_order(u_now))
        moved = float((body_conv.weight - w_before).abs().max())
    say("9 train weights", body_conv_max_update=moved, u_cache_fresh=fresh,
        peak_mem_gb=peak_gb)
    if not (fresh and moved > 0):
        raise CheckFailed("the Adam steps did not reach the Winograd U cache")

    # timing: the kernel path against the same weights on the direct cuDNN
    # trunk under autograd, in turns, 2 steps per window
    direct = build_model(dict(MODEL_CFG, winograd=None), 1, 1, "bf16", device="cuda")
    direct.load_state_dict(model.state_dict())
    steps = {"kernel": step,
             "direct": build_train_step(direct, build_optimizer(direct, TRAIN_TASK), sc)}

    def window(name, n=2):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(n):
            steps[name](batches[i % NSTEP], weight)
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / n

    timing = {}
    for name in ("kernel", "direct"):
        window(name, 1)                                 # warm-up
    for name in ("kernel", "direct", "direct", "kernel", "kernel", "direct"):
        timing.setdefault(name, []).append(window(name))
    torch.cuda.reset_peak_memory_stats(dev)
    window("direct", 1)
    peak_direct_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    out = {}
    for name, ws in timing.items():
        med = statistics.median(ws)
        out[name] = med
        say(f"9 train timing {name}", windows_ms_per_step=ws, median_ms_per_step=med,
            tiles_per_s=BATCH / (med / 1e3))
    # the step's operands are on the card: no copy from the host inside it
    busy = {name: profile_device(f"9 train profile {name}",
                                 lambda: steps[name](batches[0], weight), top=14,
                                 no_htod=True)
            for name in ("kernel", "direct")}
    say("9 train summary", kernel_ms_per_step=out["kernel"],
        direct_ms_per_step=out["direct"],
        kernel_device_idle_pct=100.0 * (1 - busy["kernel"] / out["kernel"]),
        direct_device_idle_pct=100.0 * (1 - busy["direct"] / out["direct"]),
        peak_mem_gb_kernel=peak_gb, peak_mem_gb_direct_step=peak_direct_gb)
    return total


# ------------------------------------- SwinIR (phases 10-13 and 22-24)
def _wattn_operands(dev, rng, cfg, nw, tile=(TILE96, TILE96)):
    """Window-attention operands of ``cfg`` (T = window², C, heads) at ``nw``
    windows: x (nw, T, C), the JAX-layout weights (torch-default scale), a
    0.02-scale relative-position bias (h, T, T) and the shifted-window group
    mask of a ``tile`` = (H, W) image (SwinIR's 96×96 LR tiles: 144 windows
    of 8×8, 36 of 16×16)."""
    import torch
    from sres_tpu_torch.models.swinir import shift_attn_mask
    ws = cfg["window_size"]
    t, c, h = ws ** 2, cfg["nfeatures"], cfg["num_heads"]
    u = lambda *s: torch.from_numpy(rng.uniform(-1 / 8, 1 / 8, s).astype(np.float32)).to(dev)
    x = torch.from_numpy(rng.normal(size=(nw, t, c)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.normal(scale=0.02, size=(h, t, t)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(shift_attn_mask(*tile, ws, ws // 2)).to(dev)
    return x, [u(c, 3 * c), u(3 * c), u(c, c), u(c), bias], mask


def _composition(x, wqkv, bqkv, wo, bo, bias, mask, heads):
    """The library yardstick for window attention: F.linear →
    F.scaled_dot_product_attention (attn_mask = bias + tiled mask) →
    F.linear, in x.dtype. Never called by the port."""
    import torch.nn.functional as F
    nw, t, c = x.shape
    dt = x.dtype
    am = bias[None]
    if mask is not None:
        am = (am + mask[:, None]).repeat(nw // mask.shape[0], 1, 1, 1)
    qkv = F.linear(x, wqkv.to(dt).T, bqkv.to(dt)).reshape(nw, t, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=am.to(dt))
    return F.linear(o.transpose(1, 2).reshape(nw, t, c), wo.to(dt).T, bo.to(dt))


def _wattn_flops(cfg, nw: int) -> dict:
    t, c, h = cfg["window_size"] ** 2, cfg["nfeatures"], cfg["num_heads"]
    proj = 2.0 * nw * t * c * c            # one (T, C) @ (C, C) product
    core = 2.0 * nw * h * t * t * (c // h)  # q·kᵀ or p·v over all heads
    return dict(proj=proj, core=core)


def _wattn_fwd_case(dev, rng, cfg, nw, label, tile=(TILE96, TILE96), timed=True):
    """The forward kernel against its twin at ``cfg``'s T and ``nw``
    windows, unshifted and shifted, f32 and bf16; with ``timed``, bf16 times
    against the twin and the composition, and the bound."""
    import torch
    from sres_tpu_torch.ops import window_attention as twa
    x, ws, mask = _wattn_operands(dev, rng, cfg, nw, tile)
    h, xb = cfg["num_heads"], x.bfloat16()
    worst = 0.0
    for m in (None, mask):
        name = "window_attention " + ("shifted" if m is not None else "unshifted")
        out = check_pair(name, twa.window_attention(x, *ws, m, h),
                         twa.window_attention_plain(x, *ws, m, h),
                         twa.window_attention(xb, *ws, m, h),
                         twa.window_attention_plain(xb, *ws, m, h))
        comp = _composition(x, *ws, m, h)
        torch.cuda.synchronize()
        out["composition_f32_rel"] = rel_err(comp, twa.window_attention_plain(x, *ws, m, h))
        say(label, t=x.shape[1], nw=nw, **out)
        worst = max(worst, out["bf16_vs_plain_abs"])
    if not timed:
        return None
    timing = {}
    for name, m in (("unshifted", None), ("shifted", mask)):
        timing[name] = dict(
            ms=time_ms(lambda: twa.window_attention(xb, *ws, m, h)),
            plain_ms=time_ms(lambda: twa.window_attention_plain(xb, *ws, m, h), iters=3),
            library_ms=time_ms(lambda: _composition(xb, *ws, m, h)))
    fl = _wattn_flops(cfg, nw)
    flops = 4 * fl["proj"] + 2 * fl["core"]   # qkv (3 C wide), o·wo; q·kᵀ, p·v
    # x read and y written (bf16), the group mask (f32), weights (bf16),
    # biases and the (h, T, T) bias (f32)
    nbytes = 2 * 2 * xb.numel() + 4 * mask.numel() + 2 * (ws[0].numel() + ws[2].numel()) \
        + 4 * (ws[1].numel() + ws[3].numel() + ws[4].numel())
    bound, by = bound_ms(nbytes, flops), bound_by(nbytes, flops)
    say(f"{label} timing", t=x.shape[1], nw=nw, dtype="bf16", **timing,
        bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    t = timing["shifted"]
    return dict(max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bound,
                bound_by=by, library_ms=t["library_ms"])


def _wattn_bwd_case(dev, rng, cfg, nw, label, tile=(TILE96, TILE96), timed=True):
    """The backward kernel against its twin (dx and the five weight
    gradients) as ``_wattn_fwd_case``; timed against the composition's
    autograd backward."""
    import torch
    from sres_tpu_torch.ops import window_attention as twa
    x, ws, mask = _wattn_operands(dev, rng, cfg, nw, tile)
    g = torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(dev)
    h, xb, gb = cfg["num_heads"], x.bfloat16(), g.bfloat16()
    names = ("dx", "dwqkv", "dbqkv", "dwo", "dbo", "dbias")
    worst = 0.0
    for m in (None, mask):
        outs = [fn(x.to(dt), g.to(dt), *ws, m, h) for fn, dt in (
            (twa.window_attention_bwd, torch.float32), (twa.window_attention_bwd_plain, torch.float32),
            (twa.window_attention_bwd, torch.bfloat16), (twa.window_attention_bwd_plain, torch.bfloat16))]
        torch.cuda.synchronize()
        for i, name in enumerate(names):
            out = check_pair(f"window_attention_bwd {'shifted' if m is not None else 'unshifted'} "
                             f"{name}", *(o[i] for o in outs))
            say(label, t=x.shape[1], nw=nw, **out)
            worst = max(worst, out["bf16_vs_plain_abs"])
        del outs
    if not timed:
        return None

    def library_backward(m):
        """The composition's autograd backward alone (its forward kept)."""
        leaves = [xb.detach().requires_grad_()] + [w.detach().requires_grad_() for w in ws]
        y = _composition(*leaves[:6], m, h)
        return lambda: torch.autograd.grad(y, leaves, gb, retain_graph=True)

    timing = {}
    for name, m in (("unshifted", None), ("shifted", mask)):
        timing[name] = dict(
            ms=time_ms(lambda: twa.window_attention_bwd(xb, gb, *ws, m, h)),
            plain_ms=time_ms(lambda: twa.window_attention_bwd_plain(xb, gb, *ws, m, h), iters=3),
            library_ms=time_ms(library_backward(m)))
    fl = _wattn_flops(cfg, nw)
    # recompute (qkv, q·kᵀ, p·v); dwo, do; dv, dp, dq, dk; dwqkv, dx
    flops = (3 + 2 + 3 + 3) * fl["proj"] + 6 * fl["core"]
    # x and g read and dx written (bf16); the mask; weights read (bf16);
    # f32 biases read and every weight gradient written (f32)
    nbytes = 3 * 2 * xb.numel() + 4 * mask.numel() \
        + 2 * (ws[0].numel() + ws[2].numel()) + 4 * sum(w.numel() for w in ws) \
        + 4 * (ws[1].numel() + ws[3].numel() + ws[4].numel())
    bound, by = bound_ms(nbytes, flops), bound_by(nbytes, flops)
    say(f"{label} timing", t=x.shape[1], nw=nw, dtype="bf16", **timing,
        bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    t = timing["shifted"]
    return dict(max_abs_err=worst, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=bound,
                bound_by=by, library_ms=t["library_ms"])


def phase_wattn(dev, rng):
    return _wattn_fwd_case(dev, rng, SWIN_CFG, SWIN_NW, "10 kernel window_attention")


def phase_wattn_bwd(dev, rng):
    return _wattn_bwd_case(dev, rng, SWIN_CFG, SWIN_NW, "11 kernel window_attention_bwd")


def phase_wattn_t256(dev, rng):
    """Phase 22: both kernels at SwinIR-w16's 432 windows of T = 256,
    timed; then T = 16 (4×4 windows) and T = 144 (12×12, head width 32) at
    a few windows, checked only. Each direction must launch its kernels."""
    from sres_tpu_torch.ops import window_attention as twa
    twa.reset_launches()
    kern = {"window_attention_t256": _wattn_fwd_case(
                dev, rng, SWIN16_CFG, SWIN16_NW, "22 kernel window_attention"),
            "window_attention_bwd_t256": _wattn_bwd_case(
                dev, rng, SWIN16_CFG, SWIN16_NW, "22 kernel window_attention_bwd")}
    for ws, heads, nw, tile in ((4, 4, 8, (8, 16)), (12, 2, 6, (24, 36))):
        cfg = dict(SWIN16_CFG, window_size=ws, num_heads=heads)
        _wattn_fwd_case(dev, rng, cfg, nw, "22 kernel window_attention", tile, False)
        _wattn_bwd_case(dev, rng, cfg, nw, "22 kernel window_attention_bwd", tile, False)
    launches = dict(twa.LAUNCHES)
    say("22 kernel launches", launches=launches)
    if not (launches["window_attention"] and launches["window_attention_bwd"]):
        raise CheckFailed(f"a window-attention direction launched no kernel: {launches}")
    return kern


def _composition_forward(self, win, mask=None):
    """WindowAttention.forward on the library composition (timing only)."""
    t = self.window_size ** 2
    bias = self.relative_position_bias_table[self.relative_position_index]
    bias = bias.reshape(t, t, self.num_heads).permute(2, 0, 1).float()
    return _composition(win, self.qkv.weight.T, self.qkv.bias, self.proj.weight.T,
                        self.proj.bias, bias, mask, self.num_heads)


def use_composition(model, on: bool) -> None:
    """Route every window attention of ``model`` through the composition
    (True) or back to its own forward (False)."""
    import types
    from sres_tpu_torch.models.swinir import WindowAttention
    for mod in model.modules():
        if isinstance(mod, WindowAttention):
            if on:
                mod.forward = types.MethodType(_composition_forward, mod)
            else:
                mod.__dict__.pop("forward", None)


def _windows(run, names, n):
    """Median ms per call of each of ``names`` in turns (n calls a window,
    3 windows each after a warm-up), with every window's reading."""
    import torch
    def window(name):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(n):
            run(name, i)
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / n
    for name in names:
        window(name)
    out = {}
    for name in list(names) + list(reversed(names)) + list(names):
        out.setdefault(name, []).append(window(name))
    return {k: (statistics.median(v), v) for k, v in out.items()}


def phase_swin_serve(dev, seed, cfg=SWIN_CFG, label="12 swinir"):
    """Phase 12 (``cfg`` = SWIN_CFG) or 23 (SWIN16_CFG): three requests; every
    window attention on the forward kernels and none on the backward's;
    returns the launches of both keys."""
    import torch
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import set_plain_twins
    from sres_tpu_torch.ops import window_attention as twa
    from sres_tpu_torch.trainer.step import build_eval_step, make_step_config
    model = build_model(cfg, 1, 1, precision="bf16", seed=seed, device=dev)
    sc = make_step_config(TASK_CFG, cfg)
    eval_step = build_eval_step(model, sc)
    rng = np.random.default_rng(seed + 3)
    reqs = [torch.from_numpy(smooth_fields(rng, SWIN_BATCH, SWIN_HR)).to(dev)
            for _ in range(NREQ)]
    weight = torch.ones(SWIN_BATCH, device=dev)
    eval_step(reqs[0], weight)
    torch.cuda.synchronize()
    twa.reset_launches()
    results = [eval_step(hr, weight) for hr in reqs]
    torch.cuda.synchronize()
    launches = dict(twa.LAUNCHES)
    for i, (met, (lr, out, tar, interp)) in enumerate(results):
        s, si = float(met["sloss"]), float(met["interp_sloss"])
        say(f"{label} request", request=i, sloss=s, interp_sloss=si,
            ratio_pct=100.0 * s / si, out_shape=list(out.shape))
        if not (math.isfinite(s) and math.isfinite(si) and si > 0
                and tuple(out.shape) == (SWIN_BATCH, 1, SWIN_HR, SWIN_HR)
                and bool(torch.isfinite(out).all())):
            raise CheckFailed(f"swinir request {i}: non-finite or misshapen output")
    want = dict.fromkeys(twa.LAUNCHES, 0)
    want["window_attention"] = NREQ * cfg["nlayers"] * cfg["nblocks"]
    say(f"{label} launches", launches=launches, expected=want)
    if launches != want:
        raise CheckFailed(f"swinir launches {launches} != expected {want}")

    out_k = results[0][1][1]
    set_plain_twins(model, True)
    out_p = eval_step(reqs[0], weight)[1][1]
    set_plain_twins(model, False)
    ref = build_model(cfg, 1, 1, precision="f32", device=dev)
    ref.load_state_dict(model.state_dict())
    set_plain_twins(ref, True)
    out_t = build_eval_step(ref, sc)(reqs[0], weight)[1][1]
    del ref
    e_k, e_p = rel_err(out_k, out_t), rel_err(out_p, out_t)
    say(f"{label} vs plain", bf16_kernel_rel=e_k, bf16_plain_rel=e_p,
        bound=2 * e_p + 1e-4, kernel_vs_plain_abs=float((out_k - out_p).abs().max()))
    if not e_k <= 2 * e_p + 1e-4:
        raise CheckFailed(f"swinir output outside the bf16 envelope: {e_k} > 2*{e_p}+1e-4")

    def run(name, i):
        use_composition(model, name == "composition")
        eval_step(reqs[i % NREQ], weight)
    timing = _windows(run, ("kernel", "composition"), NREQ)
    use_composition(model, False)
    for name, (med, ws) in timing.items():
        say(f"{label} timing {name}", windows_ms_per_request=ws, ms_per_request=med,
            tiles_per_s=SWIN_BATCH / (med / 1e3))
    busy = {}
    for name in ("kernel", "composition"):
        use_composition(model, name == "composition")
        busy[name] = profile_device(f"{label} profile {name}",
                                    lambda: eval_step(reqs[0], weight), top=14)
    use_composition(model, False)
    say(f"{label} summary", **{f"{k}_ms_per_request": v[0] for k, v in timing.items()},
        **{f"{k}_device_idle_pct": 100.0 * (1 - busy[k] / timing[k][0]) for k in busy})
    return launches


def phase_swin_train(dev, seed, cfg=SWIN_CFG, label="13 swinir"):
    """Phase 13 (``cfg`` = SWIN_CFG) or 24 (SWIN16_CFG); launches checked as
    in ``phase_swin_serve``; returns those of the three Adam steps."""
    import torch
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import set_plain_twins
    from sres_tpu_torch.ops import window_attention as twa
    from sres_tpu_torch.trainer.step import (build_optimizer, build_train_step,
                                             make_step_config)
    model = build_model(cfg, 1, 1, "bf16", seed=seed, device=dev)
    sc = make_step_config(TASK_CFG, cfg)
    rng = np.random.default_rng(seed + 4)
    batches = [torch.from_numpy(smooth_fields(rng, SWIN_BATCH, SWIN_HR)).to(dev)
               for _ in range(NSTEP)]
    weight = torch.ones(SWIN_BATCH, device=dev)

    # one step's loss and gradients: kernels (bf16) and plain twins (bf16)
    # against the plain twins in f32, per Swin group and the rest
    ref = build_model(cfg, 1, 1, "f32", device=dev)
    ref.load_state_dict(model.state_dict())
    set_plain_twins(ref, True)
    lt, gt = _loss_and_grads(ref, sc, batches[0], weight)
    del ref
    lk, gk = _loss_and_grads(model, sc, batches[0], weight)
    set_plain_twins(model, True)
    lp, gp = _loss_and_grads(model, sc, batches[0], weight)
    set_plain_twins(model, False)
    torch.cuda.synchronize()
    parts = {f"group{g}": (lambda n, g=g: n.startswith(f"layers.{g}."))
             for g in range(cfg["nlayers"])}
    parts["attention"] = lambda n: ".attn." in n
    parts["rest"] = lambda n: not n.startswith("layers.")
    for part, sel in parts.items():
        k, p, t = (_cat(v for n, v in gd.items() if sel(n)) for gd in (gk, gp, gt))
        for v in (k, p, t, lk, lp, lt):
            if not torch.isfinite(v).all():
                raise CheckFailed(f"swinir train {part}: non-finite gradient or loss")
        e_k, e_p = rel_err(k, t), rel_err(p, t)
        say(f"{label} train step vs plain", part=part, bf16_kernel_rel=e_k,
            bf16_plain_rel=e_p, bound=2 * e_p + 1e-4)
        if not e_k <= 2 * e_p + 1e-4:
            raise CheckFailed(f"swinir train {part}: outside the bf16 envelope "
                              f"{e_k} > 2*{e_p}+1e-4")
    e_k, e_p = rel_err(lk, lt), rel_err(lp, lt)
    say(f"{label} train step vs plain", part="loss", bf16_kernel_rel=e_k,
        bf16_plain_rel=e_p, bound=2 * e_p + 1e-4)
    if not e_k <= 2 * e_p + 1e-4:
        raise CheckFailed(f"swinir train loss outside the bf16 envelope {e_k} > 2*{e_p}+1e-4")
    del gk, gp, gt

    step = build_train_step(model, build_optimizer(model, SWIN_TRAIN_TASK), sc)
    want = dict.fromkeys(twa.LAUNCHES, cfg["nlayers"] * cfg["nblocks"])
    torch.cuda.reset_peak_memory_stats(dev)
    total, losses = dict.fromkeys(twa.LAUNCHES, 0), []
    # the Adam steps revisit one batch, so that its loss must fall; on fresh
    # batches the random-weight loss follows each batch's spread instead
    for i in range(NSTEP):
        twa.reset_launches()
        met = step(batches[0], weight)
        torch.cuda.synchronize()
        launches = dict(twa.LAUNCHES)
        vals = {k: float(v) for k, v in met.items()}
        say(f"{label} train step", step=i, **vals, launches=launches, expected=want)
        if not all(math.isfinite(v) for v in vals.values()):
            raise CheckFailed(f"swinir train step {i}: non-finite metrics {vals}")
        if launches != want:
            raise CheckFailed(f"swinir train step {i}: launches {launches} != {want}")
        losses.append(vals["mloss"])
        for k in total:
            total[k] += launches[k]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not losses[-1] < losses[0]:
        raise CheckFailed(f"swinir loss did not fall over {NSTEP} Adam steps: {losses}")

    comp = build_model(cfg, 1, 1, "bf16", device=dev)
    comp.load_state_dict(model.state_dict())
    use_composition(comp, True)
    steps = {"kernel": step,
             "composition": build_train_step(comp, build_optimizer(comp, SWIN_TRAIN_TASK), sc)}
    timing = _windows(lambda name, i: steps[name](batches[i % NSTEP], weight),
                      ("kernel", "composition"), 2)
    torch.cuda.reset_peak_memory_stats(dev)
    steps["composition"](batches[0], weight)
    torch.cuda.synchronize()
    peak_comp_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    for name, (med, ws) in timing.items():
        say(f"{label} train timing {name}", windows_ms_per_step=ws,
            median_ms_per_step=med, tiles_per_s=SWIN_BATCH / (med / 1e3))
    busy = {name: profile_device(f"{label} train profile {name}",
                                 lambda: steps[name](batches[0], weight), top=14)
            for name in ("kernel", "composition")}
    say(f"{label} train summary",
        **{f"{k}_ms_per_step": v[0] for k, v in timing.items()},
        **{f"{k}_device_idle_pct": 100.0 * (1 - busy[k] / timing[k][0]) for k in busy},
        peak_mem_gb_kernel=peak_gb, peak_mem_gb_composition_step=peak_comp_gb,
        losses=losses)
    return total


# --------------------------------------- RCAN model.fused (phases 14-17)
# config/model/rcan-10-20-64.yaml with ``fused: true`` (fused wins over
# winograd, as in JAX)
FUSED_CFG = dict({k: v for k, v in MODEL_CFG.items() if k != "winograd"}, fused=True)
ODD_SHAPE = (3, 64, 50, 38)


def _fg_inputs(dev, rng, shape):
    """Operands of the direct-conv group kernels: two activations, a ReLU
    output to mask by, conv weights (9, 64, 64) f32 (torch-default scale),
    a bias, the CA gate and ds."""
    import torch
    from sres_tpu_torch.ops.fused_group import conv_weights
    c, n = shape[1], shape[0]
    bound = 1 / math.sqrt(9 * c)
    uni = lambda *s: torch.from_numpy(rng.uniform(-bound, bound, s).astype(np.float32)).to(dev)
    w = uni(c, c, 3, 3)
    return dict(x=_rand(rng, dev, shape), r=_rand(rng, dev, shape),
                m=torch.relu(_rand(rng, dev, shape)), w=w, wk=conv_weights(w, torch.float32),
                b=uni(c), gate=_rand(rng, dev, (n, c)).sigmoid(),
                ds=_rand(rng, dev, (n, c), 1e-2))


def _fg_conv_case(o, mode, fn, dt):
    """One fgroup_conv call of ``mode`` (F1 relu; F2 partials; F3 residual;
    B1 dgrad with the CA prologue, mask and partials; B2 dgrad with the
    carried cotangent and the group skip), partials summed per sample."""
    import torch
    x, r, m = (o[k].to(dt) for k in ("x", "r", "m"))
    wk = o["wk"].to(dt)
    if mode == "relu":
        return (fn(x, wk, o["b"], relu=True),)
    if mode == "partials":
        y, p = fn(x, wk, o["b"], out_dtype=torch.float32, partials=True)
        return y, p.sum(1)
    if mode == "residual":
        return (fn(x, wk, o["b"], res=r),)
    if mode == "dgrad_mask":
        y, p = fn(x, wk, gate=o["gate"], ds=o["ds"], mask=m, partials=True)
        return y, p.sum(1)
    return (fn(x, wk, res=r, res2=m),)


def phase_fg_kernels(dev, rng):
    """Phase 14: the direct-conv group kernels against their twins."""
    import torch
    import torch.nn.functional as F
    from sres_tpu_torch.ops import fused_group as fg
    f32, bf16 = torch.float32, torch.bfloat16
    worst = dict.fromkeys(("fgroup_conv", "fgroup_ca", "fgroup_wgrad", "fgroup_ca_bwd"), 0.0)

    def check(kernel, name, outs):
        for i, (a, b, c, d) in enumerate(zip(*outs)):
            out = check_pair(f"{name}[{i}]", a, b, c, d)
            say(f"14 kernel {kernel}", **out)
            worst[kernel] = max(worst[kernel], out["bf16_vs_plain_abs"])

    for shape in (SHAPE, ODD_SHAPE):
        o = _fg_inputs(dev, rng, shape)
        for mode in ("relu", "partials", "residual", "dgrad_mask", "dgrad_carry"):
            outs = [_fg_conv_case(o, mode, fn, dt) for fn, dt in (
                (fg.fgroup_conv, f32), (fg.fgroup_conv_plain, f32),
                (fg.fgroup_conv, bf16), (fg.fgroup_conv_plain, bf16))]
            torch.cuda.synchronize()
            check("fgroup_conv", f"{mode} {shape}", outs)
            del outs
        for mode in ("plain", "prologue", "db_part"):
            kw = (dict(gate=o["gate"], ds=o["ds"]) if mode == "prologue" else
                  dict(db_part=_rand(rng, dev, (shape[0], 24, shape[1])))
                  if mode == "db_part" else {})
            outs = [fn(o["x"].to(dt), o["r"].to(dt), **kw) for fn, dt in (
                (fg.fgroup_wgrad, f32), (fg.fgroup_wgrad_plain, f32),
                (fg.fgroup_wgrad, bf16), (fg.fgroup_wgrad_plain, bf16))]
            torch.cuda.synchronize()
            check("fgroup_wgrad", f"{mode} {shape}", outs)
    # the two channel-attention kernels at the serving shape
    o = _fg_inputs(dev, rng, SHAPE)
    c, hid = SHAPE[1], SHAPE[1] // MODEL_CFG["cbottleneck"]
    ca = [torch.from_numpy(rng.uniform(-a, a, s).astype(np.float32)).to(dev)
          for a, s in ((1 / 8, (hid, c)), (1 / 8, (hid,)),
                       (1 / math.sqrt(hid), (c, hid)), (1 / math.sqrt(hid), (c,)))]
    cf, part = fg.fgroup_conv(o["x"], o["wk"], o["b"], out_dtype=f32, partials=True)
    outs = [fn(o["x"].to(dt), cf, part, *ca, stash_c=True) for fn, dt in (
        (fg.fgroup_ca, f32), (fg.fgroup_ca_plain, f32), (fg.fgroup_ca, bf16),
        (fg.fgroup_ca_plain, bf16))]
    torch.cuda.synchronize()
    check("fgroup_ca", "gate+skip", outs)
    gate = outs[0][1]
    del outs
    # the CA backward (one cooperative launch, fg_ca_bwd_kernel): at the
    # serving shape on the conv's output and the forward's gate, and at
    # samples too large for a block and an odd pixel count; the same bits on
    # two calls
    ca_bwd_ops = {SHAPE: (o["r"], cf, gate)}
    for shape in (CA_LARGE, CA_ODD):
        ca_bwd_ops[shape] = (_rand(rng, dev, shape), _rand(rng, dev, shape, shift=0.3),
                             _rand(rng, dev, (shape[0], c)).sigmoid())
    for shape, (g_, c_, gt_) in ca_bwd_ops.items():
        outs = [fn(g_.to(dt), c_.to(dt), gt_, *ca) for fn, dt in (
            (fg.fgroup_ca_bwd, f32), (fg.fgroup_ca_bwd_plain, f32), (fg.fgroup_ca_bwd, bf16),
            (fg.fgroup_ca_bwd_plain, bf16))]
        torch.cuda.synchronize()
        check("fgroup_ca_bwd", f"ca backward {shape}", outs)
        for i, dt in ((0, f32), (2, bf16)):
            again = fg.fgroup_ca_bwd(g_.to(dt), c_.to(dt), gt_, *ca)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs[i], again)):
                raise CheckFailed(f"fgroup_ca_bwd {shape} {dt}: two calls differ")
        del outs

    # timing at the serving shape, bf16, in device time (device_ms), with the
    # back-to-back events of time_ms beside; cuDNN gets channels_last weights
    xb, gb, mb = o["x"].bfloat16(), o["r"].bfloat16(), o["m"].bfloat16()
    wkb, bb = o["wk"].bfloat16(), o["b"].bfloat16()
    wb = o["w"].bfloat16().contiguous(memory_format=torch.channels_last)
    n, act = xb.numel(), 2 * xb.numel()              # elements; bf16 bytes of one
    flops = 2.0 * 9 * n * c                          # one direct conv's products
    res = {}
    convs = dict(
        relu=lambda: fg.fgroup_conv(xb, wkb, o["b"], relu=True),
        partials_f32_out=lambda: fg.fgroup_conv(xb, wkb, o["b"], out_dtype=f32, partials=True),
        residual=lambda: fg.fgroup_conv(xb, wkb, o["b"], res=gb),
        dgrad_mask=lambda: fg.fgroup_conv(xb, wkb, gate=o["gate"], ds=o["ds"], mask=mb,
                                          partials=True),
        dgrad_carry=lambda: fg.fgroup_conv(xb, wkb, res=gb, res2=mb))
    t = {k: device_ms(f) for k, f in convs.items()}
    t_events = {k: time_ms(f) for k, f in convs.items()}
    plain_ms = device_ms(lambda: fg.fgroup_conv_plain(xb, wkb, o["b"], relu=True), iters=3)
    lib = dict(
        conv2d=lambda: F.conv2d(xb, wb, bb, padding=1),
        dgrad=lambda: torch.ops.aten.convolution_backward(
            gb, xb, wb, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, False, False]),
        wgrad=lambda: torch.ops.aten.convolution_backward(
            gb, xb, wb, [c], [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [False, True, True]),
        dgrad_wgrad=lambda: torch.ops.aten.convolution_backward(
            gb, xb, wb, [c], [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, False]))
    lib_ms = {k: device_ms(f) for k, f in lib.items()}
    lib_events = {k: time_ms(f) for k, f in lib.items()}
    # x read and y written (bf16), weights, bias; conv2 writes f32; the
    # residual conv and the dgrads also read res, the mask, or the carried
    # cotangent and the skip
    wbytes = 2 * wkb.numel() + 4 * c
    nbytes = dict(relu=2 * act, partials_f32_out=3 * act, residual=3 * act, dgrad_mask=3 * act,
                  dgrad_carry=4 * act)
    bounds = {k: bound_ms(v + wbytes, flops) for k, v in nbytes.items()}
    res["fgroup_conv"] = dict(max_abs_err=worst["fgroup_conv"], ms=t["relu"],
                              plain_ms=plain_ms, bound_ms=bounds["relu"],
                              bound_by=bound_by(nbytes["relu"] + wbytes, flops),
                              library_ms=lib_ms["conv2d"], modes=t, mode_bound_ms=bounds,
                              kernels=["fg_conv_wgmma_kernel"])
    say("14 kernel fgroup_conv timing", shape=SHAPE, dtype="bf16", device_ms=t,
        events_ms=t_events, plain_ms=plain_ms, bound_ms=bounds, flops=flops,
        library_device_ms=lib_ms, library_events_ms=lib_events)

    wgrads = dict(plain=lambda: fg.fgroup_wgrad(xb, gb),
                  prologue=lambda: fg.fgroup_wgrad(xb, gb, gate=o["gate"], ds=o["ds"]),
                  db_part=lambda: fg.fgroup_wgrad(xb, gb, db_part=part))
    t = {k: device_ms(f) for k, f in wgrads.items()}
    t_events = {k: time_ms(f) for k, f in wgrads.items()}
    plain_ms = device_ms(lambda: fg.fgroup_wgrad_plain(xb, gb), iters=3)
    nbytes = 2 * act + 4 * (9 * c * c + c)            # x, g read; dW, db written f32
    res["fgroup_wgrad"] = dict(max_abs_err=worst["fgroup_wgrad"], ms=t["plain"],
                               plain_ms=plain_ms, bound_ms=bound_ms(nbytes, flops),
                               bound_by=bound_by(nbytes, flops), library_ms=lib_ms["wgrad"],
                               modes=t, kernels=["fg_wgrad_wgmma_kernel"])
    say("14 kernel fgroup_wgrad timing", shape=SHAPE, dtype="bf16", device_ms=t,
        events_ms=t_events, plain_ms=plain_ms, bound_ms=res["fgroup_wgrad"]["bound_ms"],
        library_device_ms=lib_ms["wgrad"])

    ms = device_ms(lambda: fg.fgroup_ca(xb, cf, part, *ca))
    ms_stash = device_ms(lambda: fg.fgroup_ca(xb, cf, part, *ca, stash_c=True))
    events = time_ms(lambda: fg.fgroup_ca(xb, cf, part, *ca))
    plain_ms = device_ms(lambda: fg.fgroup_ca_plain(xb, cf, part, *ca))
    nbytes = act + 4 * n + act                        # x (bf16), c (f32) read; x' written
    bounds = dict(serve=bound_ms(nbytes, 0.0), stash=bound_ms(nbytes + act, 0.0))   # + T(c)
    res["fgroup_ca"] = dict(max_abs_err=worst["fgroup_ca"], ms=ms, plain_ms=plain_ms,
                            bound_ms=bounds["serve"], bound_by="bytes", library_ms=None,
                            modes=dict(serve=ms, stash=ms_stash), mode_bound_ms=bounds,
                            kernels=["fg_ca_stream_kernel"])
    say("14 kernel fgroup_ca timing", shape=SHAPE, dtype="bf16", device_ms=ms,
        stash_device_ms=ms_stash, events_ms=events, plain_ms=plain_ms,
        bound_ms=bounds["serve"], stash_bound_ms=bounds["stash"])

    cb = cf.bfloat16()
    one_kernel("14 kernel fgroup_ca_bwd launch", lambda: fg.fgroup_ca_bwd(gb, cb, gate, *ca),
               "fg_ca_bwd_kernel")
    gL, cL, gtL = (t.bfloat16() if t.dim() == 4 else t for t in ca_bwd_ops[CA_LARGE])
    modes = {"bf16": (lambda: fg.fgroup_ca_bwd(gb, cb, gate, *ca), 2 * act),
             "bf16 " + "x".join(map(str, CA_LARGE)): (
                 lambda: fg.fgroup_ca_bwd(gL, cL, gtL, *ca), 4 * gL.numel())}
    t = {k: device_ms(f) for k, (f, _) in modes.items()}        # g and c read (bf16)
    t_events = {k: time_ms(f) for k, (f, _) in modes.items()}
    bounds = {k: bound_ms(b, 0.0) for k, (_, b) in modes.items()}
    plain_ms = device_ms(lambda: fg.fgroup_ca_bwd_plain(gb, cb, gate, *ca))
    res["fgroup_ca_bwd"] = dict(max_abs_err=worst["fgroup_ca_bwd"], ms=t["bf16"],
                                plain_ms=plain_ms, bound_ms=bounds["bf16"], bound_by="bytes",
                                library_ms=None, kernels=["fg_ca_bwd_kernel"], modes=t,
                                mode_bound_ms=bounds)
    say("14 kernel fgroup_ca_bwd timing", shape=SHAPE, device_ms=t, events_ms=t_events,
        bound_ms=bounds, plain_ms=plain_ms)
    return res


def phase_fg_group(dev, seed):
    """Phase 15: one fused group (20 RCABs + trailing conv, b72), forward
    and backward, kernels against twins; timed against the Winograd and the
    direct cuDNN group."""
    import torch
    from sres_tpu_torch.models.fused import FusedResidualGroup
    from sres_tpu_torch.models.layers import ResidualGroup, init_torch_default
    from sres_tpu_torch.models.wino_blocks import WinoResidualGroup
    from sres_tpu_torch.ops import fused_group as fg
    f32, bf16 = torch.float32, torch.bfloat16
    nb = MODEL_CFG["nblocks"]
    grp = init_torch_default(FusedResidualGroup(64, MODEL_CFG["cbottleneck"], nb),
                             seed).to(dev)
    rng = np.random.default_rng(seed + 5)
    x, gy = _rand(rng, dev, SHAPE), _rand(rng, dev, SHAPE)

    with torch.inference_mode():
        outs = {}
        for plain in (False, True):
            grp.plain = plain
            for dt in (f32, bf16):
                outs[(plain, dt)] = grp(x.to(dt))
        grp.plain = False
        torch.cuda.synchronize()
        out = check_pair("fused group forward", *(outs[k] for k in (
            (False, f32), (True, f32), (False, bf16), (True, bf16))), GROUP_F32_TOL)
        say("15 fused group forward", **out)
        del outs

    # the stash, kernels against twins, and the ReLU gates (a > 0) that
    # open on one side and not the other in f32
    with torch.no_grad():
        sts = {}
        for plain in (False, True):
            for dt in (f32, bf16):
                st = fg.new_stash()
                (fg.fused_group_fwd_plain if plain else fg.fused_group_fwd)(
                    x.to(dt), grp._operands(dt), st)
                sts[(plain, dt)] = st
        flips = sum(int(((a > 0) != (b > 0)).sum())
                    for a, b in zip(sts[(False, f32)].a, sts[(True, f32)].a))
        torch.cuda.synchronize()
        for slot in ("x", "a", "c", "gate"):
            out = check_pair(f"fused group stash {slot}", *(
                _cat(getattr(sts[k], slot)) for k in ((False, f32), (True, f32),
                                                      (False, bf16), (True, bf16))),
                GROUP_F32_TOL)
            say("15 fused group stash", relu_gates=nb * x.numel(), flipped_gates=flips,
                **out)
        del sts
    names = [n for n, _ in grp.named_parameters()]
    kinds = {"conv_w": lambda n: n.endswith("weight") and "conv_du" not in n,
             "conv_b": lambda n: n.endswith("bias") and "conv_du" not in n,
             "ca": lambda n: "conv_du" in n}

    def grads(plain, dt):
        grp.plain = plain
        xx = x.to(dt).detach().requires_grad_()
        gs = torch.autograd.grad((grp(xx).float() * gy).sum(), [xx, *grp.parameters()])
        res = {"dx": gs[0].float()}
        for kind, sel in kinds.items():
            res[kind] = _cat(g for n, g in zip(names, gs[1:]) if sel(n))
        return res

    # end to end under autograd: the f32 group bound, widened as in phase 8
    # when a gate flipped; the bf16 envelope
    tol = GROUP_F32_TOL if flips == 0 else FLIPPED_GRAD_F32_TOL
    res = {(p, dt): grads(p, dt) for p in (False, True) for dt in (f32, bf16)}
    grp.plain = False
    torch.cuda.synchronize()
    for kind in ("dx", *kinds):
        out = check_pair(f"fused group grad {kind}", *(res[k][kind] for k in (
            (False, f32), (True, f32), (False, bf16), (True, bf16))), tol)
        say("15 fused group backward", flipped_gates=flips, **out)
    del res
    # the backward kernels alone, in f32, on one shared forward (the
    # kernels' stash), within 1e-4·max
    with torch.no_grad():
        ops = grp._operands(f32)
        st = fg.new_stash()
        fg.fused_group_fwd(x, ops, st)
        rk = fg.fused_group_bwd(gy, st, ops)
        rp = fg.fused_group_bwd_plain(gy, st, ops)
        torch.cuda.synchronize()
        del st
    pairs = [("dx", rk[0], rp[0]), ("dwg", rk[2], rp[2]), ("dbg", rk[3], rp[3])]
    for i, name in enumerate(("dw1", "db1", "dw2", "db2", "dcw1", "dcb1", "dcw2", "dcb2")):
        pairs.append((name, torch.stack([g[i] for g in rk[1]]),
                      torch.stack([g[i] for g in rp[1]])))
    for name, a, b in pairs:
        err, bound = float((a - b).abs().max()), GROUP_F32_TOL * float(b.abs().max())
        say("15 fused group backward kernels, same forward", grad=name, f32_err=err,
            f32_bound=bound)
        if not err <= bound:
            raise CheckFailed(f"fused group backward {name}: {err} > {bound}")
    del rk, rp, pairs

    # timing, bf16: the same weights as a Winograd group and a direct group
    wino = WinoResidualGroup(64, MODEL_CFG["cbottleneck"], nb, 4).to(dev)
    direct = ResidualGroup(64, 3, MODEL_CFG["cbottleneck"], nb).to(dev)
    for other in (wino, direct):
        other.load_state_dict(grp.state_dict())
    groups = {"fused": grp, "winograd": wino, "direct": direct}
    xb = x.bfloat16()

    def fwd(name, i):
        with torch.inference_mode():
            groups[name](xb)

    def fwd_bwd(name, i):
        xx = xb.detach().requires_grad_()
        g = groups[name]
        torch.autograd.grad((g(xx).float() * gy).sum(), [xx, *g.parameters()])

    tf = _windows(fwd, tuple(groups), 2)
    tb = _windows(fwd_bwd, tuple(groups), 2)
    torch.cuda.reset_peak_memory_stats(dev)
    fwd_bwd("fused", 0)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    say("15 fused group timing", dtype="bf16",
        forward_ms={k: v[0] for k, v in tf.items()},
        fwd_bwd_ms={k: v[0] for k, v in tb.items()},
        forward_windows={k: v[1] for k, v in tf.items()},
        fwd_bwd_windows={k: v[1] for k, v in tb.items()}, peak_mem_gb_fused_fwd_bwd=peak)


def _all_launches():
    """The launch counts of every kernel wrapper of the port."""
    from sres_tpu_torch.ops import fused_group as fg
    from sres_tpu_torch.ops import window_attention as twa
    from sres_tpu_torch.ops import winograd_conv as wc
    return {**wc.LAUNCHES, **twa.LAUNCHES, **fg.LAUNCHES}


def _reset_all_launches():
    from sres_tpu_torch.ops import fused_group as fg
    from sres_tpu_torch.ops import window_attention as twa
    from sres_tpu_torch.ops import winograd_conv as wc
    for mod in (wc, twa, fg):
        mod.reset_launches()


def phase_fg_serve(dev, seed):
    """Phase 16: RCAN-10-20-64 ×4 with ``fused: true`` served."""
    import torch
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import set_plain_twins
    from sres_tpu_torch.trainer.step import build_eval_step, make_step_config
    model = build_model(FUSED_CFG, 1, 1, precision="bf16", seed=seed, device=dev)
    sc = make_step_config(TASK_CFG, FUSED_CFG)
    eval_step = build_eval_step(model, sc)
    rng = np.random.default_rng(seed + 6)
    reqs = [torch.from_numpy(smooth_fields(rng, BATCH, HR)).to(dev) for _ in range(NREQ)]
    weight = torch.ones(BATCH, device=dev)
    eval_step(reqs[0], weight)                 # builds the operand caches
    torch.cuda.synchronize()

    _reset_all_launches()
    results = [eval_step(hr, weight) for hr in reqs]
    torch.cuda.synchronize()
    launches = {k: v for k, v in _all_launches().items() if v}
    for i, (met, (lr, out, tar, interp)) in enumerate(results):
        s, si = float(met["sloss"]), float(met["interp_sloss"])
        say("16 fused serve request", request=i, sloss=s, interp_sloss=si,
            ratio_pct=100.0 * s / si, out_shape=list(out.shape))
        if not (math.isfinite(s) and math.isfinite(si) and si > 0
                and tuple(out.shape) == (BATCH, 1, HR, HR)
                and bool(torch.isfinite(out).all())):
            raise CheckFailed(f"fused request {i}: non-finite or misshapen output")
    nl, nb = FUSED_CFG["nlayers"], FUSED_CFG["nblocks"]
    want = {"fgroup_conv": NREQ * nl * (2 * nb + 1), "fgroup_ca": NREQ * nl * nb}
    say("16 fused serve launches", launches=launches, expected=want)
    if launches != want:
        raise CheckFailed(f"fused serving launches {launches} != expected {want}")

    out_k = results[0][1][1]
    set_plain_twins(model, True)
    out_p = eval_step(reqs[0], weight)[1][1]
    set_plain_twins(model, False)
    ref = build_model(FUSED_CFG, 1, 1, precision="f32", device=dev)
    ref.load_state_dict(model.state_dict())
    set_plain_twins(ref, True)
    out_t = build_eval_step(ref, sc)(reqs[0], weight)[1][1]
    del ref
    e_k, e_p = rel_err(out_k, out_t), rel_err(out_p, out_t)
    say("16 fused serve vs plain", bf16_kernel_rel=e_k, bf16_plain_rel=e_p,
        bound=2 * e_p + 1e-4, kernel_vs_plain_abs=float((out_k - out_p).abs().max()))
    if not e_k <= 2 * e_p + 1e-4:
        raise CheckFailed(f"fused serving outside the bf16 envelope: {e_k} > 2*{e_p}+1e-4")

    # the same weights on the Winograd and the direct trunk, in turns
    steps = {"fused": eval_step}
    for name, cfg in (("winograd", MODEL_CFG), ("direct", dict(MODEL_CFG, winograd=None))):
        other = build_model(cfg, 1, 1, "bf16", device=dev)
        other.load_state_dict(model.state_dict())
        steps[name] = build_eval_step(other, sc)
    timing = _windows(lambda name, i: steps[name](reqs[i % NREQ], weight), tuple(steps),
                      NREQ)
    for name, (med, ws) in timing.items():
        say(f"16 fused serve timing {name}", windows_ms_per_request=ws, ms_per_request=med,
            tiles_per_s=BATCH / (med / 1e3))
    torch.cuda.reset_peak_memory_stats(dev)
    eval_step(reqs[0], weight)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    busy = {name: profile_device(f"16 fused serve profile {name}",
                                 lambda: steps[name](reqs[0], weight), top=14)
            for name in steps}
    say("16 fused serve summary", **{f"{k}_ms_per_request": v[0] for k, v in timing.items()},
        **{f"{k}_tiles_per_s": BATCH / (v[0] / 1e3) for k, v in timing.items()},
        **{f"{k}_device_idle_pct": 100.0 * (1 - busy[k] / timing[k][0]) for k in busy},
        peak_mem_gb_fused_request=peak)
    return launches


def phase_fg_train(dev, seed):
    """Phase 17: RCAN-10-20-64 ×4 with ``fused: true`` trained."""
    import torch
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import set_plain_twins
    from sres_tpu_torch.trainer.step import (build_optimizer, build_train_step,
                                             make_step_config)
    nl, nb = FUSED_CFG["nlayers"], FUSED_CFG["nblocks"]
    model = build_model(FUSED_CFG, 1, 1, "bf16", seed=seed, device=dev)
    sc = make_step_config(TASK_CFG, FUSED_CFG)
    rng = np.random.default_rng(seed + 7)
    batches = [torch.from_numpy(smooth_fields(rng, BATCH, HR)).to(dev) for _ in range(NSTEP)]
    weight = torch.ones(BATCH, device=dev)

    # one step's loss and gradients: kernels (bf16) and plain twins (bf16)
    # against the plain twins in f32, per residual group and the rest
    ref = build_model(FUSED_CFG, 1, 1, "f32", device=dev)
    ref.load_state_dict(model.state_dict())
    set_plain_twins(ref, True)
    lt, gt = _loss_and_grads(ref, sc, batches[0], weight)
    del ref
    lk, gk = _loss_and_grads(model, sc, batches[0], weight)
    set_plain_twins(model, True)
    lp, gp = _loss_and_grads(model, sc, batches[0], weight)
    set_plain_twins(model, False)
    torch.cuda.synchronize()
    parts = {f"group{g}": (lambda n, g=g: n.startswith(f"body.{g}.")) for g in range(nl)}
    parts["head, body conv, tail"] = (
        lambda n: not n.startswith("body.") or n.startswith(f"body.{nl}."))
    for part, sel in parts.items():
        k, p, t = (_cat(v for n, v in gd.items() if sel(n)) for gd in (gk, gp, gt))
        for v in (k, p, t, lk, lp, lt):
            if not torch.isfinite(v).all():
                raise CheckFailed(f"fused train {part}: non-finite gradient or loss")
        e_k, e_p = rel_err(k, t), rel_err(p, t)
        say("17 fused train step vs plain", part=part, bf16_kernel_rel=e_k,
            bf16_plain_rel=e_p, bound=2 * e_p + 1e-4)
        if not e_k <= 2 * e_p + 1e-4:
            raise CheckFailed(f"fused train {part}: outside the bf16 envelope "
                              f"{e_k} > 2*{e_p}+1e-4")
    e_k, e_p = rel_err(lk, lt), rel_err(lp, lt)
    say("17 fused train step vs plain", part="loss", bf16_kernel_rel=e_k,
        bf16_plain_rel=e_p, bound=2 * e_p + 1e-4)
    if not e_k <= 2 * e_p + 1e-4:
        raise CheckFailed(f"fused train loss outside the bf16 envelope {e_k} > 2*{e_p}+1e-4")
    del gk, gp, gt

    # three Adam steps on one batch (its loss must fall), launches per step:
    # forward 2 convs + CA per RCAB, a trailing conv per group; backward per
    # group the trailing conv's wgrad and dgrad, per RCAB the CA backward,
    # 2 wgrads and 2 dgrads
    step = build_train_step(model, build_optimizer(model, TRAIN_TASK), sc)
    want = {"fgroup_conv": 2 * nl * (2 * nb + 1), "fgroup_ca": nl * nb,
            "fgroup_wgrad": nl * (2 * nb + 1), "fgroup_ca_bwd": nl * nb}
    torch.cuda.reset_peak_memory_stats(dev)
    total, losses = dict.fromkeys(want, 0), []
    for i in range(NSTEP):
        _reset_all_launches()
        met = step(batches[0], weight)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _all_launches().items() if v}
        vals = {k: float(v) for k, v in met.items()}
        say("17 fused train step", step=i, **vals, launches=launches, expected=want)
        if not all(math.isfinite(v) for v in vals.values()):
            raise CheckFailed(f"fused train step {i}: non-finite metrics {vals}")
        if launches != want:
            raise CheckFailed(f"fused train step {i}: launches {launches} != {want}")
        losses.append(vals["mloss"])
        for k in total:
            total[k] += launches[k]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not losses[-1] < losses[0]:
        raise CheckFailed(f"fused loss did not fall over {NSTEP} Adam steps: {losses}")

    steps = {"fused": step}
    peaks = {"fused": peak_gb}
    for name, cfg in (("winograd", MODEL_CFG), ("direct", dict(MODEL_CFG, winograd=None))):
        other = build_model(cfg, 1, 1, "bf16", device=dev)
        other.load_state_dict(model.state_dict())
        steps[name] = build_train_step(other, build_optimizer(other, TRAIN_TASK), sc)
    timing = _windows(lambda name, i: steps[name](batches[i % NSTEP], weight),
                      tuple(steps), 2)
    for name in ("winograd", "direct"):
        torch.cuda.reset_peak_memory_stats(dev)
        steps[name](batches[0], weight)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated(dev) / 1e9
    for name, (med, ws) in timing.items():
        say(f"17 fused train timing {name}", windows_ms_per_step=ws, median_ms_per_step=med,
            tiles_per_s=BATCH / (med / 1e3), peak_mem_gb=peaks[name])
    busy = {name: profile_device(f"17 fused train profile {name}",
                                 lambda: steps[name](batches[0], weight), top=16)
            for name in steps}
    say("17 fused train summary", **{f"{k}_ms_per_step": v[0] for k, v in timing.items()},
        **{f"{k}_tiles_per_s": BATCH / (v[0] / 1e3) for k, v in timing.items()},
        **{f"{k}_device_idle_pct": 100.0 * (1 - busy[k] / timing[k][0]) for k in busy},
        **{f"peak_mem_gb_{k}": v for k, v in peaks.items()}, losses=losses)
    return total


# ------------------------------------------ EDSR and the chain (18-21)
# config/model/edsr.yaml, plus the Winograd trunk (the ungated group)
EDSR_CFG = dict(name="edsr", nfeatures=64, nlayers=16, loss_fn="l2", kernel_size=3,
                res_scale=1.0, batch_norm=False, bias=True, downscale_factors=[2, 2],
                ups_mode="bicubic", lane_pack=2, winograd=4)
CHAIN_K = 20


def phase_chain_kernels(dev, rng):
    """Phase 18: the scaled residual epilogue of the conv kernel, and the
    conv chain (K = 20 convs + ReLU in one launch) against its twin, bit
    for bit against K ``wino_conv`` launches, timed against them and
    against K channels_last ``F.conv2d`` + ReLU."""
    import torch
    import torch.nn.functional as F
    from sres_tpu_torch.ops import winograd_conv as wc
    from sres_tpu_torch.ops.winograd import transform_weights
    f32, bf16 = torch.float32, torch.bfloat16
    c = SHAPE[1]
    x, res = _rand(rng, dev, SHAPE), _rand(rng, dev, SHAPE)
    bound = 1 / math.sqrt(9 * c)
    uni = lambda a, *s: torch.from_numpy(rng.uniform(-a, a, s).astype(np.float32)).to(dev)
    w, b = uni(bound, c, c, 3, 3), uni(bound, c)
    worst = 0.0
    for m in (2, 4):
        u = transform_weights(w, m)
        for s in (0.1, 0.8):
            run = lambda fn, dt: fn(x.to(dt), u, b, m, False, res.to(dt), s)
            out = check_pair(f"m{m}_res_scale{s}", run(wc.wino_conv, f32),
                             run(wc.wino_conv_plain, f32), run(wc.wino_conv, bf16),
                             run(wc.wino_conv_plain, bf16))
            torch.cuda.synchronize()
            say("18 kernel wino_conv scaled residual", **out)
        for dt in (f32, bf16):
            same = torch.equal(wc.wino_conv(x.to(dt), u, b, m, residual=res.to(dt),
                                            res_scale=1.0),
                               wc.wino_conv(x.to(dt), u, b, m, residual=res.to(dt)))
            if not same:
                raise CheckFailed(f"res_scale 1.0 changed the epilogue's bits (m{m}, {dt})")
    # the scaled epilogue's cost (EDSR's conv2), bf16, m=4: x and res read,
    # y written, U and the bias read
    u4b, xb, rb = wc.kernel_u(transform_weights(w, 4).bfloat16()), x.bfloat16(), res.bfloat16()
    ep = dict(ms=device_ms(lambda: wc.wino_conv(xb, u4b, b, 4, False, rb, 0.8)),
              unscaled_ms=device_ms(lambda: wc.wino_conv(xb, u4b, b, 4, False, rb)),
              plain_ms=device_ms(lambda: wc.wino_conv_plain(xb, u4b, b, 4, False, rb, 0.8),
                                 iters=3, warmup=1),
              bound_ms=bound_ms(3 * 2 * xb.numel() + 2 * u4b.u.numel() + 4 * c,
                                tap_flops(SHAPE, 4)))
    say("18 kernel wino_conv scaled residual timing", shape=SHAPE, m=4, dtype="bf16",
        res_scale=0.8, **ep)

    # the chain: kaiming-scale weights keep the activations' scale over 20
    # convs + ReLU
    kb = math.sqrt(6 / (9 * c))
    ws, bv = uni(kb, CHAIN_K, c, c, 3, 3), uni(0.05, CHAIN_K, c)
    us = {dt: transform_weights(ws, 4).to(dt) for dt in (f32, bf16)}
    # the probe path: one launch of the chain, counted alone
    wc.reset_launches()
    y_chain = wc.wino_chain_fwd(xb, us[bf16], bv, 4)
    torch.cuda.synchronize()
    launches = {"wino_chain": wc.LAUNCHES["wino_chain"]}
    say("18 chain launches", launches=launches, expected={"wino_chain": 1})
    if launches != {"wino_chain": 1}:
        raise CheckFailed(f"chain launches {launches} != 1")

    def separate(xx, u):
        for i in range(CHAIN_K):
            xx = wc.wino_conv(xx, u[i], bv[i], 4, relu=True)
        return xx

    for dt in (f32, bf16):
        k = y_chain if dt == bf16 else wc.wino_chain_fwd(x, us[f32], bv, 4)
        same = torch.equal(k, separate(x.to(dt), us[dt]))
        say("18 chain vs separate launches", dtype=str(dt), bitwise_equal=same)
        if not same:
            raise CheckFailed(f"chain != {CHAIN_K} wino_conv launches ({dt})")
    out = check_pair(f"chain K={CHAIN_K} m4", wc.wino_chain_fwd(x, us[f32], bv, 4),
                     wc.wino_chain_fwd_plain(x, us[f32], bv, 4), y_chain,
                     wc.wino_chain_fwd_plain(xb, us[bf16], bv, 4))
    torch.cuda.synchronize()
    say("18 kernel wino_chain", **out)
    worst = out["bf16_vs_plain_abs"]

    # timing, bf16, in device time: one chain launch, K launches of the conv
    # kernel (U in the kernels' order, as a model's caches keep it), the
    # twin, and K F.conv2d + ReLU on channels_last weights (the library
    # yardstick; no one PyTorch call computes the chain)
    wsb = [ws[i].bfloat16().contiguous(memory_format=torch.channels_last)
           for i in range(CHAIN_K)]
    bvb = bv.bfloat16()
    kus = wc.kernel_u(us[bf16])

    def convs():
        y = xb
        for i in range(CHAIN_K):
            y = F.relu(F.conv2d(y, wsb[i], bvb[i], padding=1))
        return y

    ms = device_ms(lambda: wc.wino_chain_fwd(xb, kus, bv, 4), iters=5)
    sep_ms = device_ms(lambda: separate(xb, kus), iters=5)
    plain_ms = device_ms(lambda: wc.wino_chain_fwd_plain(xb, us[bf16], bv, 4), iters=2,
                         warmup=1)
    conv2d_ms = device_ms(convs, iters=5)
    dev_ms = {name: profile_device(f"18 chain profile {name}", fn, top=4)
              for name, fn in (("chain", lambda: wc.wino_chain_fwd(xb, kus, bv, 4)),
                               ("separate", lambda: separate(xb, kus)))}
    # x read and y written once (bf16), K U operands (bf16) and biases (f32);
    # the K convs' tap products
    nbytes = 2 * 2 * xb.numel() + 2 * us[bf16].numel() + 4 * bv.numel()
    flops = CHAIN_K * tap_flops(SHAPE, 4)
    bnd = bound_ms(nbytes, flops)
    say("18 kernel wino_chain timing", shape=SHAPE, m=4, K=CHAIN_K, dtype="bf16", ms=ms,
        separate_launches_ms=sep_ms, plain_ms=plain_ms, k_conv2d_relu_ms=conv2d_ms,
        device_ms=dev_ms, bound_ms=bnd, bound_by=bound_by(nbytes, flops),
        separate_bound_ms=CHAIN_K * bound_ms(2 * 2 * xb.numel() + 2 * us[bf16][0].numel()
                                             + 4 * c, tap_flops(SHAPE, 4)))
    return launches, dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bnd,
                          bound_by=bound_by(nbytes, flops), library_ms=None)


def _direct_trunk(trunk, dev):
    """The direct cuDNN trunk with the same weights: ResBlocks, body conv
    and the skip, channels_last."""
    import torch
    from sres_tpu_torch.models.layers import Conv, ResBlock
    n = len(trunk) - 1
    body = torch.nn.Sequential(*[ResBlock(64, 3, True, trunk.res_scale) for _ in range(n)],
                               Conv(64, 64, 3, True)).to(dev)
    body.load_state_dict(trunk.state_dict())
    body = body.to(memory_format=torch.channels_last)
    return lambda x: body(x) + x, body


def phase_edsr_trunk(dev, seed):
    """Phase 19: one EDSR trunk (16 ResBlocks + body conv + skip, m=4,
    b72): forward, stash and gradients, kernels against twins (the rule of
    phase 8 for flipped gates; the backward kernels alone on one shared
    stash), timed against the direct cuDNN trunk."""
    import torch
    from sres_tpu_torch.models.layers import init_torch_default
    from sres_tpu_torch.models.wino_blocks import WinoResTrunk
    from sres_tpu_torch.ops import winograd_conv as wc
    f32, bf16 = torch.float32, torch.bfloat16
    nb, s = EDSR_CFG["nlayers"], EDSR_CFG["res_scale"]
    trunk = init_torch_default(WinoResTrunk(64, nb, 4, s), seed).to(dev)
    rng = np.random.default_rng(seed + 8)
    x, gy = _rand(rng, dev, SHAPE), _rand(rng, dev, SHAPE)
    with torch.inference_mode():
        outs = {}
        for plain in (False, True):
            trunk.plain = plain
            for dt in (f32, bf16):
                outs[(plain, dt)] = trunk(x.to(dt))
        trunk.plain = False
        torch.cuda.synchronize()
        out = check_pair("edsr trunk forward", *(outs[k] for k in (
            (False, f32), (True, f32), (False, bf16), (True, bf16))), GROUP_F32_TOL)
        say("19 edsr trunk forward", **out)
        del outs
    with torch.no_grad():
        sts = {}
        for plain in (False, True):
            for dt in (f32, bf16):
                ws, bv, wt, bt = trunk._operands(dt)
                st = []
                (wc.wino_resgroup_fwd_plain if plain else wc.wino_resgroup_fwd)(
                    x.to(dt), ws, bv, 4, wt, bt, s, st)
                sts[(plain, dt)] = st
        ws, bv = trunk._operands(f32)[:2]
        flips = 0
        for k in range(nb):
            pre_k = wc.wino_conv(sts[(False, f32)][k], ws[k, 0], bv[k, 0], 4)
            pre_p = wc.wino_conv_plain(sts[(True, f32)][k], ws[k, 0], bv[k, 0], 4)
            flips += int(((pre_k > 0) != (pre_p > 0)).sum())
        torch.cuda.synchronize()
        out = check_pair("edsr trunk stash", *(_cat(sts[k]) for k in (
            (False, f32), (True, f32), (False, bf16), (True, bf16))), GROUP_F32_TOL)
        say("19 edsr trunk stash", slots=nb + 1, relu_gates=nb * x.numel(),
            flipped_gates=flips, **out)
        del sts
    names = [n for n, _ in trunk.named_parameters()]
    kinds = {"conv_w": lambda n: n.endswith("weight"), "conv_b": lambda n: n.endswith("bias")}

    def grads(plain, dt):
        trunk.plain = plain
        xx = x.to(dt).detach().requires_grad_()
        gs = torch.autograd.grad((trunk(xx).float() * gy).sum(), [xx, *trunk.parameters()])
        res = {"dx": gs[0].float()}
        for kind, sel in kinds.items():
            res[kind] = _cat(g for n, g in zip(names, gs[1:]) if sel(n))
        return res

    tol = GROUP_F32_TOL if flips == 0 else FLIPPED_GRAD_F32_TOL
    res = {(p, dt): grads(p, dt) for p in (False, True) for dt in (f32, bf16)}
    trunk.plain = False
    torch.cuda.synchronize()
    for kind in ("dx", *kinds):
        out = check_pair(f"edsr trunk grad {kind}", *(res[k][kind] for k in (
            (False, f32), (True, f32), (False, bf16), (True, bf16))), tol)
        say("19 edsr trunk backward", flipped_gates=flips, **out)
    del res
    with torch.no_grad():
        ws, bv, wt, bt = trunk._operands(f32)
        st = []
        wc.wino_resgroup_fwd(x, ws, bv, 4, wt, bt, s, st)
        rk = wc.wino_resgroup_bwd(gy, st, ws, bv, 4, wt, s)
        rp = wc.wino_resgroup_bwd_plain(gy, st, ws, bv, 4, wt, s, conv=wc.wino_conv)
        torch.cuda.synchronize()
        del st
    for name, a, b in zip(("dx", "dU", "db", "dUt", "dbt"), rk, rp):
        err, bnd = float((a - b).abs().max()), GROUP_F32_TOL * float(b.abs().max())
        say("19 edsr trunk backward kernels, same forward", grad=name, f32_err=err,
            f32_bound=bnd)
        if not err <= bnd:
            raise CheckFailed(f"edsr trunk backward {name}: {err} > {bnd}")
    del rk, rp

    direct, body = _direct_trunk(trunk, dev)
    runs = {"winograd": trunk, "direct": direct}
    xb = x.bfloat16().contiguous(memory_format=torch.channels_last)

    def fwd(name, i):
        with torch.inference_mode():
            runs[name](xb)

    def fwd_bwd(name, i):
        xx = xb.detach().requires_grad_()
        ps = list(trunk.parameters() if name == "winograd" else body.parameters())
        torch.autograd.grad((runs[name](xx).float() * gy).sum(), [xx, *ps])

    tf = _windows(fwd, tuple(runs), 3)
    tb = _windows(fwd_bwd, tuple(runs), 2)
    trunk.plain = True
    plain = dict(forward_ms=time_ms(lambda: fwd("winograd", 0), iters=2, warmup=1),
                 fwd_bwd_ms=time_ms(lambda: fwd_bwd("winograd", 0), iters=2, warmup=1))
    trunk.plain = False
    torch.cuda.reset_peak_memory_stats(dev)
    fwd_bwd("winograd", 0)
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    say("19 edsr trunk timing", dtype="bf16",
        forward_ms={k: v[0] for k, v in tf.items()},
        fwd_bwd_ms={k: v[0] for k, v in tb.items()}, plain=plain,
        forward_windows={k: v[1] for k, v in tf.items()},
        fwd_bwd_windows={k: v[1] for k, v in tb.items()}, peak_mem_gb_winograd_fwd_bwd=peak)


def phase_edsr_serve(dev, seed):
    """Phase 20: EDSR ×4 (config/model/edsr.yaml + winograd: 4) served."""
    import torch
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import set_plain_twins
    from sres_tpu_torch.trainer.step import build_eval_step, make_step_config
    model = build_model(EDSR_CFG, 1, 1, precision="bf16", seed=seed, device=dev)
    sc = make_step_config(TASK_CFG, EDSR_CFG)
    eval_step = build_eval_step(model, sc)
    rng = np.random.default_rng(seed + 9)
    reqs = [torch.from_numpy(smooth_fields(rng, BATCH, HR)).to(dev) for _ in range(NREQ)]
    weight = torch.ones(BATCH, device=dev)
    eval_step(reqs[0], weight)                 # builds the U cache
    torch.cuda.synchronize()

    _reset_all_launches()
    results = [eval_step(hr, weight) for hr in reqs]
    torch.cuda.synchronize()
    launches = {k: v for k, v in _all_launches().items() if v}
    for i, (met, (lr, out, tar, interp)) in enumerate(results):
        s, si = float(met["sloss"]), float(met["interp_sloss"])
        say("20 edsr serve request", request=i, sloss=s, interp_sloss=si,
            ratio_pct=100.0 * s / si, out_shape=list(out.shape))
        if not (math.isfinite(s) and math.isfinite(si) and si > 0
                and tuple(out.shape) == (BATCH, 1, HR, HR)
                and bool(torch.isfinite(out).all())):
            raise CheckFailed(f"edsr request {i}: non-finite or misshapen output")
    want = {"wino_conv": NREQ * (2 * EDSR_CFG["nlayers"] + 1)}
    say("20 edsr serve launches", launches=launches, expected=want)
    if launches != want:
        raise CheckFailed(f"edsr serving launches {launches} != expected {want}")

    out_k = results[0][1][1]
    set_plain_twins(model, True)
    out_p = eval_step(reqs[0], weight)[1][1]
    set_plain_twins(model, False)
    ref = build_model(EDSR_CFG, 1, 1, precision="f32", device=dev)
    ref.load_state_dict(model.state_dict())
    set_plain_twins(ref, True)
    out_t = build_eval_step(ref, sc)(reqs[0], weight)[1][1]
    del ref
    e_k, e_p = rel_err(out_k, out_t), rel_err(out_p, out_t)
    say("20 edsr serve vs plain", bf16_kernel_rel=e_k, bf16_plain_rel=e_p,
        bound=2 * e_p + 1e-4, kernel_vs_plain_abs=float((out_k - out_p).abs().max()))
    if not e_k <= 2 * e_p + 1e-4:
        raise CheckFailed(f"edsr serving outside the bf16 envelope: {e_k} > 2*{e_p}+1e-4")

    # the same weights with winograd unset (the config as users run it)
    direct = build_model(dict(EDSR_CFG, winograd=None), 1, 1, "bf16", device=dev)
    direct.load_state_dict(model.state_dict())
    steps = {"winograd": eval_step, "direct": build_eval_step(direct, sc)}
    timing = _windows(lambda name, i: steps[name](reqs[i % NREQ], weight), tuple(steps),
                      NREQ)
    for name, (med, ws) in timing.items():
        say(f"20 edsr serve timing {name}", windows_ms_per_request=ws, ms_per_request=med,
            tiles_per_s=BATCH / (med / 1e3))
    torch.cuda.reset_peak_memory_stats(dev)
    eval_step(reqs[0], weight)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    busy = {name: profile_device(f"20 edsr serve profile {name}",
                                 lambda: steps[name](reqs[0], weight), top=12)
            for name in steps}
    say("20 edsr serve summary", **{f"{k}_ms_per_request": v[0] for k, v in timing.items()},
        **{f"{k}_tiles_per_s": BATCH / (v[0] / 1e3) for k, v in timing.items()},
        **{f"{k}_device_ms": v for k, v in busy.items()},
        **{f"{k}_device_idle_pct": 100.0 * (1 - busy[k] / timing[k][0]) for k in busy},
        peak_mem_gb_winograd_request=peak)
    return launches


def phase_edsr_train(dev, seed):
    """Phase 21: EDSR ×4 at winograd: 4 trained (Adam, lr 1e-4, b72)."""
    import torch
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import set_plain_twins
    from sres_tpu_torch.trainer.step import (build_optimizer, build_train_step,
                                             make_step_config)
    nl = EDSR_CFG["nlayers"]
    model = build_model(EDSR_CFG, 1, 1, "bf16", seed=seed, device=dev)
    sc = make_step_config(TASK_CFG, EDSR_CFG)
    rng = np.random.default_rng(seed + 10)
    batches = [torch.from_numpy(smooth_fields(rng, BATCH, HR)).to(dev) for _ in range(NSTEP)]
    weight = torch.ones(BATCH, device=dev)

    # one step's loss and gradients: kernels (bf16) and plain twins (bf16)
    # against the plain twins in f32, the trunk and the rest
    ref = build_model(EDSR_CFG, 1, 1, "f32", device=dev)
    ref.load_state_dict(model.state_dict())
    set_plain_twins(ref, True)
    lt, gt = _loss_and_grads(ref, sc, batches[0], weight)
    del ref
    lk, gk = _loss_and_grads(model, sc, batches[0], weight)
    set_plain_twins(model, True)
    lp, gp = _loss_and_grads(model, sc, batches[0], weight)
    set_plain_twins(model, False)
    torch.cuda.synchronize()
    parts = {"trunk": lambda n: n.startswith("body."),
             "head, tail": lambda n: not n.startswith("body."),
             "body conv": lambda n: n.startswith(f"body.{nl}.")}
    for part, sel in parts.items():
        k, p, t = (_cat(v for n, v in gd.items() if sel(n)) for gd in (gk, gp, gt))
        for v in (k, p, t, lk, lp, lt):
            if not torch.isfinite(v).all():
                raise CheckFailed(f"edsr train {part}: non-finite gradient or loss")
        e_k, e_p = rel_err(k, t), rel_err(p, t)
        say("21 edsr train step vs plain", part=part, bf16_kernel_rel=e_k,
            bf16_plain_rel=e_p, bound=2 * e_p + 1e-4)
        if not e_k <= 2 * e_p + 1e-4:
            raise CheckFailed(f"edsr train {part}: outside the bf16 envelope "
                              f"{e_k} > 2*{e_p}+1e-4")
    e_k, e_p = rel_err(lk, lt), rel_err(lp, lt)
    say("21 edsr train step vs plain", part="loss", bf16_kernel_rel=e_k,
        bf16_plain_rel=e_p, bound=2 * e_p + 1e-4)
    if not e_k <= 2 * e_p + 1e-4:
        raise CheckFailed(f"edsr train loss outside the bf16 envelope {e_k} > 2*{e_p}+1e-4")
    del gk, gp, gt

    # three Adam steps on one batch (its loss must fall); launches per
    # step: forward 2 convs per ResBlock and the body conv, backward the
    # ResBlocks' conv1 again and every conv's adjoint
    step = build_train_step(model, build_optimizer(model, TRAIN_TASK), sc)
    want = {"wino_conv": 3 * nl + 1, "wino_conv_bwd": 2 * nl + 1}
    torch.cuda.reset_peak_memory_stats(dev)
    total, losses = dict.fromkeys(want, 0), []
    for i in range(NSTEP):
        _reset_all_launches()
        met = step(batches[0], weight)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _all_launches().items() if v}
        vals = {k: float(v) for k, v in met.items()}
        say("21 edsr train step", step=i, **vals, launches=launches, expected=want)
        if not all(math.isfinite(v) for v in vals.values()):
            raise CheckFailed(f"edsr train step {i}: non-finite metrics {vals}")
        if launches != want:
            raise CheckFailed(f"edsr train step {i}: launches {launches} != {want}")
        losses.append(vals["mloss"])
        for k in total:
            total[k] += launches[k]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if not losses[-1] < losses[0]:
        raise CheckFailed(f"edsr loss did not fall over {NSTEP} Adam steps: {losses}")

    direct = build_model(dict(EDSR_CFG, winograd=None), 1, 1, "bf16", device=dev)
    direct.load_state_dict(model.state_dict())
    steps = {"winograd": step,
             "direct": build_train_step(direct, build_optimizer(direct, TRAIN_TASK), sc)}
    timing = _windows(lambda name, i: steps[name](batches[i % NSTEP], weight),
                      tuple(steps), 2)
    peaks = {"winograd": peak_gb}
    torch.cuda.reset_peak_memory_stats(dev)
    steps["direct"](batches[0], weight)
    torch.cuda.synchronize()
    peaks["direct"] = torch.cuda.max_memory_allocated(dev) / 1e9
    for name, (med, ws) in timing.items():
        say(f"21 edsr train timing {name}", windows_ms_per_step=ws, median_ms_per_step=med,
            tiles_per_s=BATCH / (med / 1e3), peak_mem_gb=peaks[name])
    busy = {name: profile_device(f"21 edsr train profile {name}",
                                 lambda: steps[name](batches[0], weight), top=14)
            for name in steps}
    say("21 edsr train summary", **{f"{k}_ms_per_step": v[0] for k, v in timing.items()},
        **{f"{k}_tiles_per_s": BATCH / (v[0] / 1e3) for k, v in timing.items()},
        **{f"{k}_device_ms": v for k, v in busy.items()},
        **{f"{k}_device_idle_pct": 100.0 * (1 - busy[k] / timing[k][0]) for k in busy},
        **{f"peak_mem_gb_{k}": v for k, v in peaks.items()}, losses=losses)
    return total


# ------------------------------------------- the trainer (phase 25)
# python -m sres_tpu_torch.train's arguments: RCAN-10-20-64 with the
# Winograd trunk on the synthetic task (config/task/synthetic-tiles-48.yaml:
# 48×48 LR tiles, batch 36, lnorm, xyflip) over a 1920×1920 region; 10
# timeslices, as the dataset's 8 leave int(0.1·8) = 0 to validation and test
TRAINER_ARGS = ["--model", "rcan-10-20-64", "--task", "synthetic-tiles-48",
                "--dataset", "synthetic", "--platform", "local", "--seed", "42",
                "model.winograd=4", "dataset.image_size={y: 1920, x: 1920}",
                "dataset.ntimes=10"]
# kernel launches a train step and an eval batch at RCAN-10-20-64 (phase 9's
# and phase 5's counts)
_NCONV = MODEL_CFG["nlayers"] * (2 * MODEL_CFG["nblocks"] + 1) + 1
_NCA = MODEL_CFG["nlayers"] * MODEL_CFG["nblocks"]
TRAIN_STEP_LAUNCHES = {"wino_conv": _NCONV + 2 * _NCA, "ca_skip": _NCA,
                       "wino_conv_bwd": _NCONV, "ca_skip_bwd": _NCA}
EVAL_STEP_LAUNCHES = {"wino_conv": _NCONV, "ca_skip": _NCA, "wino_conv_bwd": 0,
                      "ca_skip_bwd": 0}


def _csv_rows(trainer):
    import csv
    with open(trainer.results_accum.result_file_path(), newline="") as f:
        return [r for r in csv.reader(f, delimiter=",", quotechar="|")]


def _check_rows(label, rows, n):
    if len(rows) != n or not all(math.isfinite(float(x)) for r in rows for x in r[2:]):
        raise CheckFailed(f"{label}: {len(rows)} loss CSV rows (want {n}), or a non-finite loss: "
                          f"{rows}")


def _host_share(t) -> dict:
    """The trainer's host seconds by part, a step, and their share of the
    train wall."""
    parts = ("load", "assemble", "pad", "metrics_to_host", "to_device", "dispatch")
    n = max(t["steps"], 1)
    out = {f"{k}_ms_per_step": 1e3 * t[k] / n for k in parts}
    # tile assembly, padding and the metrics read, of the train wall
    out["host_share_pct"] = 100.0 * sum(t[k] for k in parts[1:4]) / max(t["train"], 1e-9)
    return out


def phase_trainer(dev, root):
    """Phase 25: RCAN-10-20-64 ``winograd: 4`` trained through the port's
    launcher (config reader → synthetic data pipeline → ModelTrainer →
    checkpoints and the loss CSV), resumed, and run with each staging, under
    ``root`` (phase 26 serves the checkpoints of its first run, under
    ``root / "a"``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.train import main as train_main
    from sres_tpu_torch.data.inference_io import TSet
    from sres_tpu_torch.trainer.step import (build_optimizer, build_train_step,
                                             make_step_config)
    from sres_tpu_torch.trainer.trainer import ModelTrainer
    run_step, run_slice = ModelTrainer._run_train_step, ModelTrainer._train_timeslice
    seen = dict(batches=[], first=None, slices=[], profile=None)

    def capture_step(self, hr, weight):
        # the padded batches and the first step's weights and metrics
        if seen["first"] is None:
            seen["first"] = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        seen["batches"].append((hr.copy(), weight.copy()))
        met = run_step(self, hr, weight)
        if len(seen["batches"]) == 1:
            seen["first_metrics"] = {k: v.detach().clone() for k, v in met.items()}
        return met

    def timed_slice(self, train_times, itime):
        # each timeslice's wall to the card's end, the steps in it; the
        # third one under torch.profiler
        steps0, t0 = self.timers["steps"], time.perf_counter()
        if len(seen["slices"]) == 2:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                out = run_slice(self, train_times, itime)
                torch.cuda.synchronize()
            rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
            seen["profile"] = (rows, self.timers["steps"] - steps0)
        else:
            out = run_slice(self, train_times, itime)
            torch.cuda.synchronize()
        seen["slices"].append((time.perf_counter() - t0, self.timers["steps"] - steps0))
        return out

    def launch(tag, *extra):
        from sres_tpu_torch.ops import winograd_conv as wc
        _reset_all_launches()
        t0 = time.perf_counter()
        ctl = train_main(TRAINER_ARGS + [f"platform.root={root / tag}"] + list(extra))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: wc.LAUNCHES[k] for k in TRAIN_STEP_LAUNCHES}
        return ctl.trainer, wall, launches

    def expect(t):
        # zero-weight micro-batches of an accumulation tail run the step too
        return {k: int(t.timers["steps"] + t.timers["pad_batches"]) * TRAIN_STEP_LAUNCHES[k]
                + int(t.timers["eval_steps"]) * EVAL_STEP_LAUNCHES[k]
                for k in TRAIN_STEP_LAUNCHES}

    # 25a: one epoch from the seeded weights
    ModelTrainer._run_train_step, ModelTrainer._train_timeslice = capture_step, timed_slice
    torch.cuda.reset_peak_memory_stats(dev)
    try:
        tr, wall, launches_a = launch("a", "task.nepochs=1")
    finally:
        ModelTrainer._run_train_step, ModelTrainer._train_timeslice = run_step, run_slice
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    t = dict(tr.timers)
    rows = _csv_rows(tr)
    ckpts = sorted(p.name.split(".", 1)[1] for p in (root / "a/results/checkpoints").iterdir())
    nts = len(tr.data_timestamps[TSet.Train])
    # the first timeslice builds the step's caches, the third is profiled
    steady = seen["slices"][1:2] + seen["slices"][3:]
    steady_ms = 1e3 * sum(w for w, _ in steady) / max(sum(n for _, n in steady), 1)
    say("25a trainer epoch", wall_s=wall, train_s=t["train"], steps=t["steps"],
        eval_steps=t["eval_steps"], train_timeslices=nts, rows=len(rows), checkpoints=ckpts,
        trainer_ms_per_step=1e3 * t["train"] / t["steps"],
        trainer_ms_per_step_steady=steady_ms,
        validation_s=t["valid"], test_s=t["test"], peak_mem_gb=peak_gb,
        launches=launches_a, expected=expect(tr), **_host_share(t))
    _check_rows("25a", rows, nts + 2)
    if not {"train.ckpt", "valid.ckpt"} <= set(ckpts):
        raise CheckFailed(f"25a: checkpoint slots {ckpts}")
    if launches_a != expect(tr) or min(launches_a.values()) <= 0:
        raise CheckFailed(f"25a: launches {launches_a} != {expect(tr)}")
    prof_rows, prof_steps = seen["profile"]
    busy = sum(ms for _, ms, _ in prof_rows)
    htod = [dict(copy=k, ms=ms, calls=n) for k, ms, n in prof_rows
            if k.startswith("Memcpy HtoD")]
    prof_rows.sort(key=lambda r: -r[1])
    say("25a trainer profile, one timeslice", steps=prof_steps, device_ms_total=busy,
        device_ms_per_step=busy / max(prof_steps, 1),
        device_idle_pct=100.0 * (1 - busy / max(prof_steps, 1) / steady_ms), htod=htod,
        top=[dict(kernel=k[:90], ms=ms, calls=n) for k, ms, n in prof_rows[:10]])

    # the first step against build_train_step on the same padded batch
    # and weights, and build_train_step alone over the epoch's batches
    model = build_model(MODEL_CFG, 1, 1, "bf16", device="cuda")
    model.load_state_dict(seen["first"])
    del tr
    step = build_train_step(model, build_optimizer(model, TRAIN_TASK),
                            make_step_config(TASK_CFG, MODEL_CFG))
    staged = [(torch.from_numpy(h).to(dev), torch.from_numpy(w).to(dev))
              for h, w in seen["batches"]]
    met = step(*staged[0])
    first = seen["first_metrics"]
    same = all(torch.equal(met[k], first[k]) for k in met)
    say("25a first step vs build_train_step", trainer={k: float(v) for k, v in first.items()},
        step={k: float(v) for k, v in met.items()}, bit_equal=same)
    if not same:
        raise CheckFailed("25a: the trainer's first step differs from build_train_step's")
    for hw in staged[1:3]:
        step(*hw)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for hw in staged:
        step(*hw)
    torch.cuda.synchronize()
    alone_ms = 1e3 * (time.perf_counter() - t0) / len(staged)
    say("25a trainer vs build_train_step alone", steps=len(staged),
        step_alone_ms_per_step=alone_ms, trainer_ms_per_step_steady=steady_ms,
        trainer_over_alone=steady_ms / alone_ms)
    del model, step, staged, seen["batches"]

    # 25b: resume from the train checkpoint for one more epoch
    tr, wall, launches = launch("a", "task.nepochs=2")
    rows_b = _csv_rows(tr)
    say("25b trainer resumed", wall_s=wall, steps=tr.timers["steps"],
        eval_steps=tr.timers["eval_steps"], rows=len(rows_b), first_new_row=rows_b[nts + 2],
        launches=launches, expected=expect(tr))
    # the checkpoint's timeslice again (reference semantics), validation,
    # epoch 2, validation, test
    _check_rows("25b", rows_b, (nts + 2) + (nts + 4))
    if rows_b[nts + 2][:2] != ["train", f"{(nts - 1) / nts:.3f}"] or launches != expect(tr):
        raise CheckFailed(f"25b: resumed at {rows_b[nts + 2]}, launches {launches}")
    del tr

    # 25c: the staging modes, K = 2, on 3 timeslices (2 trained)
    for tag, knob in (("accum", "pipeline.grad_accum=2"),
                      ("multi", "pipeline.steps_per_dispatch=2")):
        tr, wall, launches = launch(tag, "task.nepochs=1", "dataset.ntimes=3", knob)
        rows_c = _csv_rows(tr)
        updates = {int(s["step"]) for s in tr.optimizer.state_dict()["state"].values()}
        nsteps = int(tr.timers["steps"])
        say(f"25c trainer {tag}", wall_s=wall, steps=nsteps, adam_updates=sorted(updates),
            rows=len(rows_c), trainer_ms_per_step=1e3 * tr.timers["train"] / nsteps,
            launches=launches, expected=expect(tr))
        _check_rows(f"25c {tag}", rows_c, 2)
        want_updates = {nsteps} if tag == "multi" else set(range(nsteps // 2, nsteps))
        if not updates <= want_updates or launches != expect(tr):
            raise CheckFailed(f"25c {tag}: {updates} updates for {nsteps} batches, "
                              f"launches {launches}")
        del tr
    return launches_a


# ------------------------------------------------------------ 26 serving
# the region modes' configuration: phase 25's run (TRAINER_ARGS) at a
# region size, served from its platform.root
REGION_GROUPS = dict(task="synthetic-tiles-48", dataset="synthetic", pipeline="sres",
                     platform="local")
REGION_SIZES = (1920, 3840)
# HR tile (48×48 LR ×4) and the seamless halo in HR pixels (the default of
# infer_region_seamless, which the controller calls)
REGION_TILE, REGION_MARGIN = 192, 8


def _region_overrides(size, root):
    return {"model.winograd": 4, "dataset.image_size": {"y": size, "x": size},
            "dataset.ntimes": 10, "platform.root": str(root)}


def _raw_region(tr, ctime):
    """The raw SST of the active region, its NaN mask, and the mask of the
    tiles a tiled mode drops (any NaN in the tile)."""
    region = tr.dataset.load_region_data(ctime).data
    grid = tr.dataset.tile_grid
    ishape = dict(c=region.shape[0], y=region.shape[1], x=region.shape[2])
    roi = grid.get_active_region(image_shape=ishape)
    gs = grid.get_grid_shape(image_shape=ishape)
    raw = region[0, roi["y"][0]:roi["y"][1], roi["x"][0]:roi["x"][1]]
    t = REGION_TILE
    dropped = ~np.isfinite(raw.reshape(gs["y"], t, gs["x"], t)).all(axis=(1, 3))
    return raw, ~np.isfinite(raw), np.repeat(np.repeat(dropped, t, 0), t, 1)


def _check_image(label, panels, raw, holes):
    """Holes where expected, the model finite wherever the target is, the
    target equal to the raw region (rtol 2e-4, tests/test_workflow.py:
    245-247)."""
    tgt, mod = panels["target"].data, panels["model"].data
    if tgt.shape != raw.shape or not np.array_equal(np.isnan(tgt), holes):
        raise CheckFailed(f"{label}: target holes are not where the region's are")
    if not np.array_equal(np.isfinite(mod), ~holes):
        raise CheckFailed(f"{label}: the model panel is not finite exactly where the target is")
    keep = ~holes
    if not np.allclose(tgt[keep], raw[keep], rtol=2e-4, atol=2e-4):
        raise CheckFailed(f"{label}: target does not round-trip to the raw region: max |d| "
                          f"{float(np.abs(tgt[keep] - raw[keep]).max())}")


def _check_netcdf(label, structure, timestep, written):
    from sres_tpu_torch.data.inference_io import load_inference_results
    back, _ = load_inference_results("SST", structure, timestep)
    for k, v in written.items():
        want = np.asarray(v.data, np.float32)
        if not np.array_equal(back[k].data, want, equal_nan=True):
            raise CheckFailed(f"{label}: NetCDF {k} does not read back as written: "
                              f"{back[k].data.shape} {want.shape}")


class _Serving:
    """Swap another model into the trainer (the region step uses
    ``trainer.model``, the tile modes ``trainer._eval_step``)."""

    def __init__(self, tr, model):
        from sres_tpu_torch.trainer.step import build_eval_step
        self.tr, self.new = tr, (model, build_eval_step(model, tr.step_config))

    def __enter__(self):
        self.old = self.tr.model, self.tr._eval_step
        self.tr.model, self.tr._eval_step = self.new

    def __exit__(self, *exc):
        self.tr.model, self.tr._eval_step = self.old


def _twins_and_direct(tr, dev):
    """The served weights on the plain twins (bf16 is the trainer's own
    model with ``set_plain_twins``; f32) and on the direct cuDNN trunk (bf16,
    f32)."""
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import set_plain_twins
    sd = tr.model.state_dict()
    out = {}
    for name, cfg, prec in (("plain_f32", MODEL_CFG, "f32"),
                            ("direct_f32", dict(MODEL_CFG, winograd=None), "f32"),
                            ("direct_bf16", dict(MODEL_CFG, winograd=None), "bf16")):
        m = build_model(cfg, 1, 1, prec, device=dev)
        m.load_state_dict(sd)
        set_plain_twins(m, True)
        out[name] = m.eval()
    return out


def _panel_err(a, ref):
    fin = np.isfinite(ref)
    if not np.array_equal(fin, np.isfinite(a)):
        raise CheckFailed("the holes differ between paths")
    return float(np.abs(a[fin] - ref[fin]).max() / np.abs(ref[fin]).max())


def _hold(label, tr, run, served, others):
    """``served``'s model panel (the kernel path, bf16) against the same
    run on the plain twins and the direct trunk: in f32 the twins and cuDNN
    within GROUP_F32_TOL, and the kernels within the bf16 envelope of each,
    2·rel_err(twins bf16, f32) + 1e-4 and 2·rel_err(cuDNN bf16, f32) +
    1e-4 (errors over the finite pixels, against the twins in f32)."""
    from sres_tpu_torch.models.layers import set_plain_twins
    set_plain_twins(tr.model, True)
    try:
        got = {"plain_bf16": run(update_model=False)}
    finally:
        set_plain_twins(tr.model, False)
    for name, m in others.items():
        with _Serving(tr, m):
            got[name] = run(update_model=False)
    ref = got["plain_f32"]
    e = {k: _panel_err(v, ref) for k, v in got.items() if k != "plain_f32"}
    e["kernel_bf16"] = _panel_err(served, ref)
    e["f32_direct_vs_plain"] = e.pop("direct_f32")
    bounds = {k: 2 * e[k] + 1e-4 for k in ("plain_bf16", "direct_bf16")}
    res = dict(case=label, bf16_kernel_rel=e["kernel_bf16"], bf16_plain_rel=e["plain_bf16"],
               bf16_direct_rel=e["direct_bf16"], bound=bounds["plain_bf16"],
               direct_bound=bounds["direct_bf16"],
               f32_direct_vs_plain_rel=e["f32_direct_vs_plain"], f32_bound=GROUP_F32_TOL)
    if not (e["kernel_bf16"] <= min(bounds.values())
            and e["f32_direct_vs_plain"] <= GROUP_F32_TOL):
        raise CheckFailed(f"{label} against twins and direct trunk: {res}")
    return res


def _device_busy(fn):
    """One call of ``fn`` under torch.profiler: (device-busy ms, kernel
    rows)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def _served(tr, fn, ntiles, nregions, dev, warm=True, profiled=True):
    """A mode served: with ``warm``, one call first (the shape's first-use
    costs); then the timed call: its wall, launches, host parts (the
    trainer's timers), peak memory; with ``profiled``, one more call under
    torch.profiler for device time and idle share."""
    import torch
    from sres_tpu_torch.ops import winograd_conv as wc
    t_mode = time.perf_counter()
    if warm:
        fn()
    timers0 = dict(tr.timers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    wc.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: wc.LAUNCHES[k] for k in ("wino_conv", "ca_skip")}
    host = {f"{k}_s": tr.timers[k] - timers0.get(k, 0.0) for k in tr.timers
            if k.startswith("region_") or k in ("netcdf_write", "checkpoint_load")}
    stats = dict(_t0=t_mode, seconds_per_region=wall / nregions, hr_tiles_per_s=ntiles / wall,
                 peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                 eval_steps=int(tr.timers["eval_steps"] - timers0.get("eval_steps", 0)),
                 launches_per_region={k: v / nregions for k, v in launches.items()}, host=host)
    if profiled:
        busy, rows = _device_busy(fn)
        stats.update(device_ms_per_region=busy / nregions,
                     device_idle_pct=100.0 * (1 - busy / 1e3 / wall),
                     top=[dict(kernel=k[:60], ms=ms, calls=n) for k, ms, n in rows[:5]])
    return out, wall, launches, stats


def phase_region(dev, root):
    """Phase 26: RCAN-10-20-64 ``winograd: 4`` served from phase 25's
    best-validation checkpoint through ``WorkflowController.inference`` and
    ``inference_stream``, in every region mode at 1920² HR and in two at
    3840²."""
    import torch
    from sres_tpu_torch.config import ConfigContext
    from sres_tpu_torch.controller import ResultStructure, TSet, WorkflowController
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.trainer.checkpoints import CheckpointManager, read_checkpoint
    Image, Tiles = ResultStructure.Image, ResultStructure.Tiles
    region_launches = {"wino_conv": 0, "ca_skip": 0}

    for size in REGION_SIZES:
        t_setup = time.perf_counter()
        ctl = WorkflowController("sres", REGION_GROUPS, seed=42)
        ctl.initialize("sres", "rcan-10-20-64", **REGION_GROUPS,
                       **_region_overrides(size, root))
        try:
            tr = ctl.trainer
            tr.init_data_timestamps()
            cv, ct = tr.data_timestamps[TSet.Validation][0], tr.data_timestamps[TSet.Test][0]
            raw, nan_mask, tile_mask = _raw_region(tr, cv)
            ntiles = int((~tile_mask).sum()) // REGION_TILE ** 2
            tag = f"26 region {size}"
            first = size == REGION_SIZES[0]
            # the seeded weights served first, so the U caches hold them
            tr.infer_region(cv, update_model=False)
            torch.cuda.synchronize()
            say(f"{tag} setup", s=time.perf_counter() - t_setup)
            others = {}

            def mode(name, run, panels, check, ntiles=ntiles, nforward=1, **extra):
                """``run(update_model, save)`` served as a user calls it,
                checked, held against the twins and the direct trunk at
                1920²; one line."""
                out, _, launches, st = _served(tr, run, ntiles, 1, dev)
                nforward = nforward or st["eval_steps"]
                for k, v in launches.items():
                    region_launches[k] += v
                if launches != {k: nforward * EVAL_STEP_LAUNCHES[k] for k in launches}:
                    raise CheckFailed(f"{tag} {name}: launches {launches}, {nforward} forwards")
                check(panels(out))
                if others:
                    extra.update(_hold(f"{tag} {name}", tr,
                                       lambda **kw: panels(run(save=False, **kw))["model"].data,
                                       panels(out)["model"].data, others))
                say(f"{tag} {name}", mode_s=time.perf_counter() - st.pop("_t0"), **st, **extra)
                return out

            def checked(structure, timestep, holes, raw_=raw):
                def check(p):
                    _check_image(f"{tag} {structure.value} {timestep}", p, raw_, holes)
                    _check_netcdf(f"{tag} {structure.value} {timestep}", structure, timestep, p)
                return check

            # infer_region: one padded batch of every grid slot
            out = mode("infer_region",
                       lambda update_model=True, save=True: tr.infer_region(
                           cv, update_model=update_model),
                       lambda r: r["SST"],
                       lambda p: _check_image(f"{tag} infer_region", p, raw, tile_mask),
                       slots=(size // REGION_TILE) ** 2, tiles=ntiles)
            # no stale U: a fresh model built from the checkpoint serves the same
            fresh = build_model(MODEL_CFG, 1, 1, "bf16", seed=7, device=dev)
            fresh.load_state_dict(read_checkpoint(
                CheckpointManager.checkpoint_path(TSet.Validation))["model"])
            with _Serving(tr, fresh):
                again = tr.infer_region(cv)["SST"]["model"].data
            del fresh
            same = np.array_equal(again, out["SST"]["model"].data, equal_nan=True)
            say(f"{tag} infer_region after update_model vs a fresh model", bit_equal=same)
            if not same:
                raise CheckFailed(f"{tag}: served after update_model differs from a fresh model")
            if first:
                others.update(_twins_and_direct(tr, dev))
                # the direct-trunk and twin comparison of infer_region
                extra = _hold(f"{tag} infer_region", tr,
                              lambda **kw: tr.infer_region(cv, **kw)["SST"]["model"].data,
                              out["SST"]["model"].data, others)
                say(f"{tag} infer_region against twins and direct trunk", **extra)

            mode("spatial",
                 lambda **kw: ctl.inference(cv, Image, region_mode="spatial", **kw),
                 lambda r: r[0]["SST"], checked(Image, cv, nan_mask),
                 lr_shape=[1, 64, size // 4, size // 4])
            if not first:
                phase_region_sample(tr, dev, size)
                continue

            # Tiles: the validation timestep's tiles (eval batches of 36),
            # each tile's target its lnorm'd raw values
            want = tr.dataset.load_timeslice(cv).data[:, 0].astype(np.float64)
            want = (want - want.mean(axis=(1, 2), keepdims=True)) / \
                want.std(axis=(1, 2), keepdims=True)

            def tiles_check(p):
                if not (p["target"].shape == want.shape
                        and np.allclose(p["target"].data, want, rtol=2e-4, atol=2e-4)
                        and np.isfinite(p["model"].data).all()):
                    raise CheckFailed(f"{tag} Tiles: target tiles are not the normalized region's")
                _check_netcdf(f"{tag} Tiles", Tiles, 0, p)

            mode("Tiles", lambda **kw: ctl.inference(0, Tiles, **kw), lambda r: r[0]["SST"],
                 tiles_check, nforward=0)
            # Image, tiled: process_image (eval batches, host assembly); as in
            # JAX it serves the train list's timestep 0
            raw0, _, tile0 = _raw_region(tr, tr.data_timestamps[TSet.Train][0])
            mode("Image tiled", lambda **kw: ctl.inference(0, Image, **kw),
                 lambda r: r[0]["SST"], checked(Image, 0, tile0, raw0),
                 ntiles=int((~tile0).sum()) // REGION_TILE ** 2, nforward=0)
            # seamless: haloed tiles (48 + 2·2 LR) in one eval batch
            mode("seamless", lambda **kw: ctl.inference(cv, Image, region_mode="seamless", **kw),
                 lambda r: r[0]["SST"], checked(Image, cv, tile_mask), margin=REGION_MARGIN)
            others.clear()

            # the stream over the validation and test timeslices, saved as
            # NetCDF; each slice equals infer_region of it, bit for bit; its
            # wall with one prep thread (prefetch 2) and with none, in turns,
            # each after emptying the loader's caches so that every prep makes
            # its fields anew; the first run profiled
            alone = {c: tr.infer_region(c)["SST"] for c in (cv, ct)}
            ntiles2 = ntiles + int((~_raw_region(tr, ct)[2]).sum()) // REGION_TILE ** 2
            walls, lines = {}, []
            loader = tr.dataset.srbatch.data_loader
            for i, pf in enumerate((2, 0, 0, 2)):
                loader._cache.clear()
                out, wall, launches, st = _served(
                    tr, lambda: list(ctl.inference_stream([cv, ct], prefetch=pf)), ntiles2, 2,
                    dev, warm=False, profiled=i == 0)
                for k, v in launches.items():
                    region_launches[k] += v
                if launches != {k: 2 * EVAL_STEP_LAUNCHES[k] for k in launches}:
                    raise CheckFailed(f"{tag} stream: launches {launches}")
                walls.setdefault(pf, []).append(wall)
                lines.append(st)
                for ts, images in out:
                    _check_netcdf(f"{tag} stream", Image, ts, images["SST"])
                    for k, v in images["SST"].items():
                        if not np.array_equal(v.data, alone[ts][k].data, equal_nan=True):
                            raise CheckFailed(f"{tag} stream: slice {ts} {k} differs "
                                              "from infer_region")
            st = lines[0]
            say(f"{tag} infer_region_stream", mode_s=time.perf_counter() - st.pop("_t0"), **st,
                slices=2, wall_prefetch2_s=walls[2], wall_no_thread_s=walls[0],
                thread_over_no_thread=sum(walls[2]) / sum(walls[0]),
                # the launch loop's host time (2 slices) in each run, in turns
                dispatch_s_prefetch_2_0_0_2=[ln["host"]["region_dispatch_s"] for ln in lines])
        finally:
            ConfigContext.deactivate()
            del ctl
    return region_launches


def phase_region_sample(tr, dev, size):
    """Rows 1 and 4 at the largest whole-region sample: the first RCAB of
    the served model's first group (two convs and the channel attention,
    ``wino_group_fwd``) on (1, 64, size/4, size/4) against its twin."""
    import torch
    from sres_tpu_torch.models.wino_blocks import group_params
    from sres_tpu_torch.ops import winograd_conv as wc
    ps = group_params(tr.model.body[0])
    w = torch.stack([ps[0], ps[2]])[None].detach()
    b = torch.stack([ps[1], ps[3]])[None].detach()
    ca = [p.detach().float().reshape(p.shape[:2] if p.dim() == 4 else p.shape)[None]
          for p in ps[4:8]]
    gen = torch.Generator(dev).manual_seed(26)
    x = torch.randn((1, 64, size // 4, size // 4), generator=gen, device=dev)
    with torch.no_grad():
        res = {}
        for dt in (torch.float32, torch.bfloat16):
            xx = x.to(dt).contiguous(memory_format=torch.channels_last)
            res[dt] = (wc.wino_group_fwd(xx, w, b, *ca, 4),
                       wc.wino_group_fwd_plain(xx, w, b, *ca, 4))
        torch.cuda.synchronize()
    (k32, p32), (kbf, pbf) = res[torch.float32], res[torch.bfloat16]
    say(f"26 region {size} rows 1 and 4 at one sample",
        **check_pair(f"wino_group_fwd (1, 64, {size // 4}, {size // 4})", k32, p32, kbf, pbf,
                     GROUP_F32_TOL))


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this test "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import sres_tpu_torch
    if not Path(sres_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"chip_smoke: sres_tpu_torch is not this checkout's "
              f"({sres_tpu_torch.__file__})", file=sys.stderr)
        return 2
    from sres_tpu_torch.device import resolve_device
    dev = resolve_device("cuda")
    CARD = card()
    # f32 references in full f32: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(args.seed)

    t_all = time.perf_counter()
    build_s = phase_toolchain()
    kern = {"wino_conv": phase_conv(dev, rng), "ca_skip": phase_ca(dev, rng)}
    phase_group(dev, args.seed)
    serve_launches = phase_slice(dev, args.seed)
    kern["wino_conv_bwd"] = phase_conv_bwd(dev, rng)
    kern["ca_skip_bwd"] = phase_ca_bwd(dev, rng)
    phase_group_bwd(dev, args.seed)
    launches = phase_train(dev, args.seed)
    kern["window_attention"] = phase_wattn(dev, rng)
    kern["window_attention_bwd"] = phase_wattn_bwd(dev, rng)
    serve_launches.update(phase_swin_serve(dev, args.seed))
    launches.update(phase_swin_train(dev, args.seed))
    kern.update(phase_fg_kernels(dev, rng))
    phase_fg_group(dev, args.seed)
    serve_launches.update(phase_fg_serve(dev, args.seed))
    launches.update(phase_fg_train(dev, args.seed))
    chain_launches, kern["wino_chain"] = phase_chain_kernels(dev, rng)
    phase_edsr_trunk(dev, args.seed)
    # EDSR's trunk runs on the same conv and conv-adjoint kernels as RCAN's
    for k, v in phase_edsr_serve(dev, args.seed).items():
        serve_launches[k] += v
    for k, v in phase_edsr_train(dev, args.seed).items():
        launches[k] += v
    launches.update(chain_launches)
    kern.update(phase_wattn_t256(dev, rng))
    w16 = phase_swin_serve(dev, args.seed, SWIN16_CFG, "23 swinir-w16")
    serve_launches["window_attention_t256"] = w16["window_attention"]
    w16 = phase_swin_train(dev, args.seed, SWIN16_CFG, "24 swinir-w16")
    launches["window_attention_t256"] = w16["window_attention"]
    launches["window_attention_bwd_t256"] = w16["window_attention_bwd"]
    root = Path(tempfile.mkdtemp(prefix="sres_trainer_"))
    try:
        trainer_launches = phase_trainer(dev, root)
        region_launches = phase_region(dev, root / "a")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say("done", total_s=time.perf_counter() - t_all, build_s=build_s)

    src = "sres_tpu_torch/ops/cuda/winograd.cu"
    bwd_src = "sres_tpu_torch/ops/cuda/winograd_bwd.cu"
    wa_src = "sres_tpu_torch/ops/cuda/window_attention.cu"
    fg_src = "sres_tpu_torch/ops/cuda/fused_group.cu"
    where = {"wino_conv": (src, "sres_tpu/ops/pallas/winograd_conv.py:81"),
             "ca_skip": (src, "sres_tpu/ops/pallas/winograd_conv.py:454"),
             "wino_conv_bwd": (bwd_src, "sres_tpu/ops/pallas/winograd_conv.py:212"),
             "ca_skip_bwd": (bwd_src, "sres_tpu/ops/pallas/wino_group_grad.py:324"),
             "window_attention": (wa_src, "sres_tpu/ops/pallas/window_attention.py:74"),
             "window_attention_bwd": (wa_src, "sres_tpu/ops/pallas/window_attention.py:84"),
             "window_attention_t256": (wa_src, "sres_tpu/ops/pallas/window_attention.py:74"),
             "window_attention_bwd_t256": (wa_src,
                                           "sres_tpu/ops/pallas/window_attention.py:84"),
             "fgroup_conv": (fg_src, "sres_tpu/ops/pallas/attic/residual_group.py:80"),
             "fgroup_ca": (fg_src, "sres_tpu/ops/pallas/attic/residual_group.py:80"),
             "fgroup_wgrad": (fg_src, "sres_tpu/ops/pallas/attic/residual_group.py:194"),
             "fgroup_ca_bwd": (fg_src, "sres_tpu/ops/pallas/attic/residual_group.py:194"),
             "wino_chain": (src, "sres_tpu/ops/pallas/winograd_conv.py:339")}
    # the CUDA kernels behind each window-attention entry
    fwd = ["wattn_fwd_core_kernel", "wattn_fwd_proj_kernel"]
    bwd = ["wattn_bwd_core_kernel", "wattn_bwd_proj_kernel", "sum_partials_kernel"]
    cuda_kernels = {"window_attention": dict(t=64, kernels=fwd),
                    "window_attention_bwd": dict(t=64, kernels=bwd),
                    "window_attention_t256": dict(t=256, kernels=fwd),
                    "window_attention_bwd_t256": dict(t=256, kernels=bwd)}
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=where[k][0], replaces=where[k][1],
             launches=launches[k], serve_launches=serve_launches.get(k, 0),
             trainer_launches=trainer_launches.get(k, 0),
             region_launches=region_launches.get(k, 0), **kern[k],
             **cuda_kernels.get(k, {}))
        for k in where]}))
    print(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
