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
   region;
27. the repo's real data formats, on fixtures written to a temporary
   directory (about 6.3 GB) and deleted at the end: (a) a SWOT dataset at
   the real LLC4320 grid (nx = 4320: a 0.97 GB mask template and 0.87 GB
   of big-endian ocean values a file; SSS and SST, 3 timesteps), the
   compiled decoder against its numpy twin on one timestep, bit for bit,
   then scripts/train/train-sss_sst-swot-2.2v_southpacific.py's
   configuration through ``train.main`` (``swot_southpacific_1200``, 36 HR
   tiles a timeslice; ``task.ttsplit`` 0.67/0.34, since the task's split
   leaves none of 3 timesteps to validation): the CSV, the best-validation
   checkpoint, the launches, the first step bit for bit against
   build_train_step, the load's parts (read, decode, panel assembly, crop),
   ms a step, the idle share of a profiled timeslice, peak memory; (b) its
   checkpoint served: ``inference(0, Tiles)`` (inference-swot.py's mode;
   each tile its own variable's lnorm, NetCDF read back) and
   ``infer_region`` at 36 slots, and at ``swot_20-20e``'s ROI (1350 slots
   in one padded batch) the same weights: each variable's target its own
   raw region, the model panels held against the twins and cuDNN as in
   phase 26; (c) 720 hourly 192² Cape Basin fields through
   scripts/train/train-rcan-cape_basin.py's configuration on
   ``LLC4320`` (the time domain, b32): the CSV, the split, ``evaluate`` on
   the validation starts; (d) ``to_zarr.main`` of ``swot_20-20e`` read
   back bit for bit against ``load_region_data``;
28. the model zoo: VDSR, DBPN, LatticeNet, ESRT, SRDN, UNet (4 temporal
   features), LapSRN and MSCNN at their config/model YAMLs' widths, bf16
   on SST-tiles-48's shapes; none of them runs a kernel of the port, and
   every launch count stays 0 over the phase. Per model: (a) one seeded set
   of weights on the card and the CPU, f32 and TF32 off: the forward of 2
   tiles (every pyramid level), one train step's loss and BN running
   statistics within 1e-4·max (SRDN 1e-3) and its gradients in the
   envelope of an f64 CPU step (the card's distance from it within twice
   the CPU's f32 distance + 1e-4·max, SRDN 1e-3), the bf16 forward
   within the envelope, and a step on 72 tiles whose last 7 are
   zero-weight padding against a step on the 65 valid ones (BN statistics
   within 1e-5·max, the loss within 1e-5); (b) three requests of 72 HR
   tiles through build_eval_step and three Adam steps (lr 1e-4) at batch 72
   through build_train_step: ms, tiles/s, peak memory, FLOP from the
   module shapes (``module_flops``) and TF/s, the idle share and a
   device-time profile of one call; (c) ``train.main`` on the synthetic
   task over a 1920² land-free region of 2 timeslices at batch 36 (3 steps,
   the last batch 28 valid tiles), the CSV, the first step bit for bit
   against build_train_step, the BN buffers through the checkpoint, then
   ``infer_region`` of the best-validation checkpoint (100 slots) against
   the f32 model in the envelope of the bf16 eval step.
   ``python3 chip_smoke.py --only 28`` runs the toolchain phase and this
   phase alone (a rehearsal; it prints no result line);
29. ``model.quantization`` on the s8 kernels (``ops/cuda/int8_conv.cu``):
   (a) ``q8_quantize`` at every scale-group kind (pairs of samples, one
   sample, output channels, input channels of the flipped weights, the
   whole g·sx; int8_fused's and AQT's grids, f32 and bf16),
   ``s8_conv_fprop`` at (72, 64, 48, 48) in pairs and alone and at VDSR's
   (72, 1 → 64, 192, 192) and (72, 64, 192, 192), ``s8_conv_wgrad`` at
   (72, 64, 48, 48) in pairs, each bit for bit against its twin and timed
   in device time against its bound (int8 operations over 1979 TOP/s) and
   cuDNN's bf16 conv or wgrad of the same integer operands; int8_fused's
   backward convs on the kernels' and the twins' operands; (b)
   RCAN-10-20-64 as its YAML sets it (no Winograd: quantization switches
   it off) served under ``int8`` and ``int8_fused`` (three requests of 72
   tiles, 411 ``s8_conv_fprop`` and 822 ``q8_quantize`` launches each) and
   trained under ``int8_fused`` and ``int8_full`` (remat on; 1232 fprops
   with the recompute and the dx convs, 411 wgrads, 2875 quantizations a
   step), three Adam steps each (the loss must fall), every one in turns
   with the bf16 direct trunk of the same weights: ms, tiles/s, peak
   memory, idle share; the int8_fused loss of one batch in the twins'
   envelope; (c) EDSR and VDSR at their YAMLs served under int8_fused and
   trained under int8_full for two steps, with their launches.
   ``python3 chip_smoke.py --only 29`` runs the toolchain phase and this
   phase alone.

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
served calls, the comparisons' and the profiled repeats' left out;
``real_data_launches`` over phase 27's training runs and served calls;
``zoo_launches`` over phase 28, which must be 0 for every kernel; the
chain's over the one probe launch of phase 18; the int8 kernels'
``launches`` over phase 29's train steps and ``serve_launches`` over its
served requests, their ``replaces`` naming the XLA op of sres_tpu that
they stand for, since no Pallas kernel did), the card's
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
T0 = time.perf_counter()   # the script's clock, reset by main


def say(phase: str, **kv) -> None:
    """One line: the phase, then its values and ``at_s``, the script's clock."""
    kv["at_s"] = time.perf_counter() - T0
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
    from sres_tpu_torch.ops import int8_conv as q8
    from sres_tpu_torch.ops import window_attention as twa
    from sres_tpu_torch.ops import winograd_conv as wc
    return {**wc.LAUNCHES, **twa.LAUNCHES, **fg.LAUNCHES, **q8.LAUNCHES}


def _reset_all_launches():
    from sres_tpu_torch.ops import fused_group as fg
    from sres_tpu_torch.ops import int8_conv as q8
    from sres_tpu_torch.ops import window_attention as twa
    from sres_tpu_torch.ops import winograd_conv as wc
    for mod in (wc, twa, fg, q8):
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


class _TrainerCapture:
    """While active, ``ModelTrainer`` keeps the padded batches it trains on,
    the first step's weights and metrics, each timeslice's wall to the
    card's end with its steps (``slices``), and runs timeslice number
    ``profiled`` under torch.profiler (``profile``: its device rows and
    steps)."""

    def __init__(self, profiled: int):
        self.profiled = profiled
        self.batches, self.first, self.first_metrics = [], None, None
        self.ntemporal = 0
        self.slices, self.profile = [], None

    def __enter__(self):
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from sres_tpu_torch.trainer.trainer import ModelTrainer
        self.saved = run_step, run_slice = (ModelTrainer._run_train_step,
                                            ModelTrainer._train_timeslice)
        seen = self

        def capture_step(tr, hr, weight, ctime=None):
            if seen.first is None:
                seen.first = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
                seen.ntemporal = tr.step_config.ntemporal
            t = tr._temporal_arg(ctime, hr.shape[0])
            seen.batches.append((hr.copy(), weight.copy()) + (() if t is None else (t,)))
            met = run_step(tr, hr, weight, ctime)
            if len(seen.batches) == 1:
                seen.first_metrics = {k: v.detach().clone() for k, v in met.items()}
            return met

        def timed_slice(tr, train_times, itime):
            # the wall to the card's end; the profiler's own processing after
            # it is left out
            steps0, t0 = tr.timers["steps"], time.perf_counter()
            if len(seen.slices) == seen.profiled:
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    out = run_slice(tr, train_times, itime)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                        for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
                seen.profile = (rows, tr.timers["steps"] - steps0)
            else:
                out = run_slice(tr, train_times, itime)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            seen.slices.append((wall, tr.timers["steps"] - steps0))
            return out

        ModelTrainer._run_train_step, ModelTrainer._train_timeslice = capture_step, timed_slice
        return self

    def __exit__(self, *exc):
        from sres_tpu_torch.trainer.trainer import ModelTrainer
        ModelTrainer._run_train_step, ModelTrainer._train_timeslice = self.saved

    def profile_line(self, label, wall_ms_per_step):
        """The profiled timeslice: device ms, idle share against
        ``wall_ms_per_step``, its host-to-device copies, the top kernels."""
        rows, steps = self.profile
        busy = sum(ms for _, ms, _ in rows)
        htod = [dict(copy=k, ms=ms, calls=n) for k, ms, n in rows if k.startswith("Memcpy HtoD")]
        rows = sorted(rows, key=lambda r: -r[1])
        idle = 100.0 * (1 - busy / max(steps, 1) / wall_ms_per_step)
        say(label, steps=steps, device_ms_total=busy, device_ms_per_step=busy / max(steps, 1),
            device_idle_pct=idle, htod=htod,
            top=[dict(kernel=k[:90], ms=ms, calls=n) for k, ms, n in rows[:10]])
        return busy, idle

    def first_step(self, label, dev, model_cfg, task):
        """The first step against build_train_step on the same padded batch
        and weights, bit for bit; returns the step and the batches on the
        card."""
        import torch
        from sres_tpu_torch.models import build_model
        from sres_tpu_torch.trainer.step import (build_optimizer, build_train_step,
                                                 make_step_config)
        from sres_tpu_torch.models.layers import has_batch_norm
        nin, nout = len(task["input_variables"]), len(task["target_variables"])
        ntf = self.ntemporal
        model = build_model(model_cfg, nin, nout, "bf16", device="cuda",
                            temporal_features=ntf or None)
        model.load_state_dict(self.first)
        step = build_train_step(model, build_optimizer(model, task),
                                make_step_config(task, model_cfg, has_batch_norm(model), ntf))
        staged = [tuple(torch.from_numpy(a).to(dev) for a in b) for b in self.batches]
        met = step(*staged[0])
        same = all(torch.equal(met[k], self.first_metrics[k]) for k in met)
        say(f"{label} first step vs build_train_step",
            trainer={k: float(v) for k, v in self.first_metrics.items()},
            step={k: float(v) for k, v in met.items()}, bit_equal=same)
        if not same:
            raise CheckFailed(f"{label}: the trainer's first step differs from build_train_step's")
        return step, staged


def _launches_of(t):
    """The kernels' launches expected of a trainer's run: its steps (the
    zero-weight micro-batches of an accumulation tail run the step too) and
    its eval batches."""
    return {k: int(t.timers["steps"] + t.timers["pad_batches"]) * TRAIN_STEP_LAUNCHES[k]
            + int(t.timers["eval_steps"]) * EVAL_STEP_LAUNCHES[k]
            for k in TRAIN_STEP_LAUNCHES}


def _train_launch(args):
    """``train.main(args)`` with every launch count at 0 before it: the
    trainer, its wall to the card's end, and its launches."""
    import torch
    from sres_tpu_torch.ops import winograd_conv as wc
    from sres_tpu_torch.train import main as train_main
    _reset_all_launches()
    t0 = time.perf_counter()
    ctl = train_main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return ctl.trainer, wall, {k: wc.LAUNCHES[k] for k in TRAIN_STEP_LAUNCHES}


def phase_trainer(dev, root):
    """Phase 25: RCAN-10-20-64 ``winograd: 4`` trained through the port's
    launcher (config reader → synthetic data pipeline → ModelTrainer →
    checkpoints and the loss CSV), resumed, and run with each staging, under
    ``root`` (phase 26 serves the checkpoints of its first run, under
    ``root / "a"``)."""
    import torch
    from sres_tpu_torch.data.inference_io import TSet

    def launch(tag, *extra):
        return _train_launch(TRAINER_ARGS + [f"platform.root={root / tag}"] + list(extra))

    # 25a: one epoch from the seeded weights; the first timeslice builds the
    # step's caches, the third is profiled
    torch.cuda.reset_peak_memory_stats(dev)
    with _TrainerCapture(profiled=2) as seen:
        tr, wall, launches_a = launch("a", "task.nepochs=1")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    t = dict(tr.timers)
    rows = _csv_rows(tr)
    ckpts = sorted(p.name.split(".", 1)[1] for p in (root / "a/results/checkpoints").iterdir())
    nts = len(tr.data_timestamps[TSet.Train])
    steady = seen.slices[1:2] + seen.slices[3:]
    steady_ms = 1e3 * sum(w for w, _ in steady) / max(sum(n for _, n in steady), 1)
    say("25a trainer epoch", wall_s=wall, train_s=t["train"], steps=t["steps"],
        eval_steps=t["eval_steps"], train_timeslices=nts, rows=len(rows), checkpoints=ckpts,
        trainer_ms_per_step=1e3 * t["train"] / t["steps"],
        trainer_ms_per_step_steady=steady_ms,
        validation_s=t["valid"], test_s=t["test"], peak_mem_gb=peak_gb,
        launches=launches_a, expected=_launches_of(tr), **_host_share(t))
    _check_rows("25a", rows, nts + 2)
    if not {"train.ckpt", "valid.ckpt"} <= set(ckpts):
        raise CheckFailed(f"25a: checkpoint slots {ckpts}")
    if launches_a != _launches_of(tr) or min(launches_a.values()) <= 0:
        raise CheckFailed(f"25a: launches {launches_a} != {_launches_of(tr)}")
    seen.profile_line("25a trainer profile, one timeslice", steady_ms)

    # the first step against build_train_step on the same padded batch
    # and weights, and build_train_step alone over the epoch's batches
    del tr
    step, staged = seen.first_step("25a", dev, MODEL_CFG, TRAIN_TASK)
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
    del step, staged, seen

    # 25b: resume from the train checkpoint for one more epoch
    tr, wall, launches = launch("a", "task.nepochs=2")
    rows_b = _csv_rows(tr)
    say("25b trainer resumed", wall_s=wall, steps=tr.timers["steps"],
        eval_steps=tr.timers["eval_steps"], rows=len(rows_b), first_new_row=rows_b[nts + 2],
        launches=launches, expected=_launches_of(tr))
    # the checkpoint's timeslice again (reference semantics), validation,
    # epoch 2, validation, test
    _check_rows("25b", rows_b, (nts + 2) + (nts + 4))
    if rows_b[nts + 2][:2] != ["train", f"{(nts - 1) / nts:.3f}"] or launches != _launches_of(tr):
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
            launches=launches, expected=_launches_of(tr))
        _check_rows(f"25c {tag}", rows_c, 2)
        want_updates = {nsteps} if tag == "multi" else set(range(nsteps // 2, nsteps))
        if not updates <= want_updates or launches != _launches_of(tr):
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
    region, dropped, _ = _active_region(tr, ctime)
    return region[0], ~np.isfinite(region[0]), dropped


def _active_region(tr, ctime):
    """The raw (C, Y, X) active region of a timestep, the mask of the tiles
    a tiled mode drops (any NaN in any channel), and the grid's shape."""
    region = tr.dataset.load_region_data(ctime).data
    grid = tr.dataset.tile_grid
    ishape = dict(c=region.shape[0], y=region.shape[1], x=region.shape[2])
    roi = grid.get_active_region(image_shape=ishape)
    gs = grid.get_grid_shape(image_shape=ishape)
    act = region[:, roi["y"][0]:roi["y"][1], roi["x"][0]:roi["x"][1]]
    t = REGION_TILE
    ok = np.isfinite(act.reshape(act.shape[0], gs["y"], t, gs["x"], t)).all(axis=(0, 2, 4))
    return act, np.repeat(np.repeat(~ok, t, 0), t, 1), gs


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


def _check_netcdf(label, structure, timestep, written, var="SST"):
    from sres_tpu_torch.data.inference_io import load_inference_results
    back, _ = load_inference_results(var, structure, timestep)
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
    nin, nout = len(tr.input_variables), len(tr.target_variables)
    out = {}
    for name, cfg, prec in (("plain_f32", MODEL_CFG, "f32"),
                            ("direct_f32", dict(MODEL_CFG, winograd=None), "f32"),
                            ("direct_bf16", dict(MODEL_CFG, winograd=None), "bf16")):
        m = build_model(cfg, nin, nout, prec, device=dev)
        m.load_state_dict(sd)
        set_plain_twins(m, True)
        out[name] = m.eval()
    return out


def _panel_err(a, ref):
    fin = np.isfinite(ref)
    if not np.array_equal(fin, np.isfinite(a)):
        raise CheckFailed("the holes differ between paths")
    return float(np.abs(a[fin] - ref[fin]).max() / np.abs(ref[fin]).max())


def _hold(label, tr, run, served, others, twin_misses_cudnn_ok=False):
    """``served``'s model panel (the kernel path, bf16) against the same
    run on the plain twins and the direct trunk: in f32 the twins and cuDNN
    within GROUP_F32_TOL, and the kernels within the bf16 envelope of each,
    2·rel_err(twins bf16, f32) + 1e-4 and 2·rel_err(cuDNN bf16, f32) +
    1e-4 (errors over the finite pixels, against the twins in f32). With
    ``twin_misses_cudnn_ok``, a miss of cuDNN's envelope passes where the
    twins in bf16 miss it too (the Winograd algorithm's bf16 rounding, not
    the kernel's: phase 27's white-noise SWOT fixture)."""
    from sres_tpu_torch.models.layers import set_plain_twins
    secs = {}
    t0 = time.perf_counter()
    set_plain_twins(tr.model, True)
    try:
        got = {"plain_bf16": run(update_model=False)}
    finally:
        set_plain_twins(tr.model, False)
    secs["plain_bf16"] = time.perf_counter() - t0
    for name, m in others.items():
        t0 = time.perf_counter()
        with _Serving(tr, m):
            got[name] = run(update_model=False)
        secs[name] = time.perf_counter() - t0
    ref = got["plain_f32"]
    e = {k: _panel_err(v, ref) for k, v in got.items() if k != "plain_f32"}
    e["kernel_bf16"] = _panel_err(served, ref)
    e["f32_direct_vs_plain"] = e.pop("direct_f32")
    bounds = {k: 2 * e[k] + 1e-4 for k in ("plain_bf16", "direct_bf16")}
    res = dict(case=label, bf16_kernel_rel=e["kernel_bf16"], bf16_plain_rel=e["plain_bf16"],
               bf16_direct_rel=e["direct_bf16"], bound=bounds["plain_bf16"],
               direct_bound=bounds["direct_bf16"],
               f32_direct_vs_plain_rel=e["f32_direct_vs_plain"], f32_bound=GROUP_F32_TOL,
               run_s=secs,
               kernel_within_direct_bound=e["kernel_bf16"] <= bounds["direct_bf16"],
               plain_within_direct_bound=e["plain_bf16"] <= bounds["direct_bf16"])
    direct_ok = res["kernel_within_direct_bound"] or (
        twin_misses_cudnn_ok and not res["plain_within_direct_bound"])
    if not (e["kernel_bf16"] <= bounds["plain_bf16"] and direct_ok
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


# ----------------------------------------------------- 27 real data formats
# the SWOT fixture: the real LLC4320 grid (13·4320² points: a 0.97 GB mask
# template, 0.87 GB of big-endian ocean values a file), SSS and SST, 3
# timesteps, in config/dataset/swot*.yaml's layout
SWOT_NX, SWOT_NTIMES, SWOT_VARS = 4320, 3, ("SSS", "SST")
# scripts/train/train-sss_sst-swot-2.2v_southpacific.py through the port's
# launcher, one epoch, model.winograd=4; the one reduction is the split: 3
# timesteps leave none to validation at the task's 0.95 / 0.05, so 0.67 /
# 0.34 (2 train, 1 validation)
SWOT_GROUPS = dict(task="SSS_SST-tiles-48", dataset="swot_southpacific_1200",
                   pipeline="sres", platform="local")
SWOT_SPLIT = {"train": 0.67, "valid": 0.34, "test": 0.0}
SWOT_TASK = dict(input_variables=list(SWOT_VARS), target_variables=list(SWOT_VARS),
                 downsample_mode="cubic", upsample_mode="cubic", lr=5e-5)
# scripts/train/train-rcan-cape_basin.py on config/dataset/LLC4320.yaml: 720
# hourly 192×192 HR fields, cape_basin_1x1 (batch 32 of consecutive hours at
# one location), the task's own split
CAPE_HOURS = 720
CAPE_GROUPS = dict(task="cape_basin_1x1", dataset="LLC4320", pipeline="sres",
                   platform="local")


def _args(groups, overrides):
    """The launchers' arguments for RCAN-10-20-64 on ``groups``."""
    return (["--model", "rcan-10-20-64", "--task", groups["task"], "--dataset",
             groups["dataset"], "--platform", groups["platform"], "--seed", "42"]
            + [f"{k}={v}" for k, v in overrides.items()])


def _tree_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def _same_bits(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint32), b.view(np.uint32))


def phase_decoder(fixture):
    """27a: the compiled decoder against its numpy twin on one full
    timestep, bit for bit, NaN pattern included."""
    import os
    from sres_tpu_torch import native
    native.load()
    t = [time.perf_counter()]
    mask = np.fromfile(fixture / "meta/hFacC_k0.data", ">f4") != 0
    raw = np.fromfile(fixture / "raw/SST/SST.0000.shrunk", np.uint32)
    t.append(time.perf_counter())
    smap = native.build_scatter_map(mask)
    t.append(time.perf_counter())
    full = native.decode_timestep(raw, smap)
    t.append(time.perf_counter())
    plain_map = native.build_scatter_map_plain(mask)
    t.append(time.perf_counter())
    plain = native.decode_timestep_plain(raw, smap)
    t.append(time.perf_counter())
    same_map = np.array_equal(smap, plain_map)
    same = _same_bits(full, plain)
    land = np.array_equal(np.isnan(full), ~mask)
    say("27a decoder vs its numpy twin, one timestep", points=int(mask.size),
        ocean=int(mask.sum()), bit_equal=same, map_equal=same_map, nan_where_land=land,
        read_s=t[1] - t[0], map_s=t[2] - t[1], decode_s=t[3] - t[2],
        map_plain_s=t[4] - t[3], decode_plain_s=t[5] - t[4],
        build_s=native.build_seconds, cpu_count=os.cpu_count(),
        cpus_usable=len(os.sched_getaffinity(0)))
    if not (same and same_map and land):
        raise CheckFailed("27a: the compiled decoder differs from its numpy twin")


def _check_panels(label, images, region, holes):
    """Each variable's served panels: the target its own raw region (rtol
    2e-4, its own stats), NaN exactly at ``holes``, the model finite
    elsewhere."""
    for iv, var in enumerate(SWOT_VARS):
        tgt, mod = images[var]["target"].data, images[var]["model"].data
        raw = region[iv]
        if tgt.shape != raw.shape or not np.array_equal(np.isnan(tgt), holes) \
                or not np.array_equal(np.isfinite(mod), ~holes):
            raise CheckFailed(f"{label} {var}: holes or shape differ from the region's")
        if not np.allclose(tgt[~holes], raw[~holes], rtol=2e-4, atol=2e-4):
            raise CheckFailed(f"{label} {var}: target is not the raw region (max |d| "
                              f"{float(np.abs(tgt[~holes] - raw[~holes]).max())})")


def phase_real_data(dev, tmp):
    """Phase 27: the repo's real data formats through the port's launchers
    on RCAN-10-20-64 ``winograd: 4``: SWOT at the real LLC4320 grid, trained
    (27a) and served (27b); LLC4320 Cape Basin's time domain (27c); the zarr
    export (27d). Fixtures under ``tmp``, deleted by the caller."""
    import shutil as sh
    import torch
    from sres_tpu_torch.config import ConfigContext, cfg
    from sres_tpu_torch.controller import ResultStructure, TSet, WorkflowController
    from sres_tpu_torch.data.synthetic import _field, write_swot_fixture
    from sres_tpu_torch.trainer.checkpoints import CheckpointManager
    from sres_tpu_torch.trainer.trainer import ttsplit_times
    launches = {k: 0 for k in TRAIN_STEP_LAUNCHES}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # 27a: the fixture, the decoder, one epoch through the launcher
    fixture, root = tmp / "swot", tmp / "swot_run"
    t0 = time.perf_counter()
    write_swot_fixture(str(fixture), nx=SWOT_NX, ntimes=SWOT_NTIMES, varnames=SWOT_VARS)
    say("27a SWOT fixture", nx=SWOT_NX, variables=SWOT_VARS, timesteps=SWOT_NTIMES,
        bytes=_tree_bytes(fixture), write_s=time.perf_counter() - t0,
        disk_free_gb=sh.disk_usage(tmp).free / 1e9)
    phase_decoder(fixture)
    over = {"model.winograd": 4, "dataset.dataset_root": str(fixture),
            "platform.root": str(root), "task.ttsplit": SWOT_SPLIT}
    torch.cuda.reset_peak_memory_stats(dev)
    with _TrainerCapture(profiled=1) as seen:
        tr, wall, counts = _train_launch(_args(SWOT_GROUPS, dict(over, **{"task.nepochs": 1})))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    add(counts)
    t, parts = dict(tr.timers), dict(tr.dataset.srbatch.data_loader.timers)
    rows = _csv_rows(tr)
    nts, nval = (len(tr.data_timestamps[s]) for s in (TSet.Train, TSet.Validation))
    ckpts = sorted(p.name.split(".", 1)[1] for p in (root / "results/checkpoints").iterdir())
    prof_wall, prof_steps = seen.slices[1]
    say("27a SWOT trainer epoch", split=SWOT_SPLIT,
        reduction="ttsplit 0.67/0.34/0: the task's 0.95/0.05 leaves none of 3 timesteps "
                  "to validation", wall_s=wall, train_s=t["train"], steps=t["steps"],
        eval_steps=t["eval_steps"], train_timeslices=nts, valid_timeslices=nval,
        rows=len(rows), checkpoints=ckpts, ms_per_step=1e3 * t["train"] / t["steps"],
        timeslice_walls_s=[w for w, _ in seen.slices], validation_s=t["valid"],
        load_s=t["load"], load_parts_s=parts, peak_mem_gb=peak_gb, launches=counts,
        expected=_launches_of(tr), **_host_share(t))
    _check_rows("27a", rows, nts + nval)
    if "valid.ckpt" not in ckpts or nval < 1:
        raise CheckFailed(f"27a: no best-validation checkpoint: {ckpts}")
    if counts != _launches_of(tr) or min(counts.values()) <= 0:
        raise CheckFailed(f"27a: launches {counts} != {_launches_of(tr)}")
    seen.profile_line("27a SWOT trainer profile, the second timeslice (its load included)",
                      1e3 * prof_wall / max(prof_steps, 1))
    del tr
    seen.first_step("27a SWOT", dev, MODEL_CFG, SWOT_TASK)
    del seen

    # 27b: served from 27a's best-validation checkpoint: Tiles (the mode of
    # scripts/inference/inference-swot.py) and infer_region at 36 slots, then
    # the same weights at swot_20-20e's ROI, 1350 slots in one padded batch
    ckpt_a = None
    for groups in (SWOT_GROUPS, dict(SWOT_GROUPS, dataset="swot_20-20e")):
        ctl = WorkflowController("sres", groups, seed=42)
        try:
            ctl.initialize("sres", "rcan-10-20-64", **groups, **over)
            tr = ctl.trainer
            if ckpt_a is None:
                ckpt_a = CheckpointManager.checkpoint_path(TSet.Validation)
            else:
                sh.copyfile(ckpt_a, CheckpointManager.checkpoint_path(TSet.Validation))
            tr.init_data_timestamps()
            cv = tr.data_timestamps[TSet.Validation][0]
            region, holes, gs = _active_region(tr, cv)
            nslots = gs["x"] * gs["y"]
            ntiles = nslots - int(holes.sum()) // REGION_TILE ** 2
            tag = f"27b {groups['dataset']} {nslots} slots"
            loader = tr.dataset.srbatch.data_loader
            parts0 = dict(loader.timers)

            def region_run(update_model=True):
                return tr.infer_region(cv, update_model=update_model)

            out, _, counts, st = _served(tr, region_run, ntiles, 1, dev)
            add(counts)
            if counts != {k: EVAL_STEP_LAUNCHES[k] for k in counts}:
                raise CheckFailed(f"{tag}: launches {counts} a forward")
            _check_panels(tag, out, region, holes)
            model_panels = lambda r: np.stack([r[v]["model"].data for v in SWOT_VARS])
            # white-noise fields: the twins' bf16 may miss cuDNN's envelope
            held = _hold(tag, tr, lambda **kw: model_panels(region_run(**kw)), model_panels(out),
                         _twins_and_direct(tr, dev), twin_misses_cudnn_ok=True)
            say(f"{tag} infer_region", mode_s=time.perf_counter() - st.pop("_t0"),
                slots=nslots, tiles=ntiles, grid=gs, **st,
                load_parts_s={k: v - parts0.get(k, 0.0) for k, v in loader.timers.items()},
                **held)
            if groups is not SWOT_GROUPS:
                continue
            # Tiles at the validation timestep: each tile's target its own
            # variable's lnorm'd raw values; the NetCDF files read back
            tiles = tr.dataset.load_timeslice(cv).data.astype(np.float64)
            want = (tiles - tiles.mean(axis=(2, 3), keepdims=True)) / \
                tiles.std(axis=(2, 3), keepdims=True)

            def tiles_run(update_model=True, save=True):
                return ctl.inference(0, ResultStructure.Tiles, update_model=update_model,
                                     save=save)

            out, _, counts, st = _served(tr, tiles_run, ntiles, 1, dev)
            add(counts)
            if counts != {k: st["eval_steps"] * EVAL_STEP_LAUNCHES[k] for k in counts}:
                raise CheckFailed(f"27b Tiles: launches {counts}")
            for iv, var in enumerate(SWOT_VARS):
                p = out[0][var]
                if not (p["target"].shape == want[:, iv].shape
                        and np.allclose(p["target"].data, want[:, iv], rtol=2e-4, atol=2e-4)
                        and np.isfinite(p["model"].data).all()):
                    raise CheckFailed(f"27b Tiles {var}: target tiles are not the normalized "
                                      "region's")
                _check_netcdf(f"27b Tiles {var}", ResultStructure.Tiles, 0, p, var)
            say("27b swot_southpacific_1200 Tiles (inference-swot.py's mode)",
                mode_s=time.perf_counter() - st.pop("_t0"), tiles=ntiles, **st)
        finally:
            ConfigContext.deactivate()
            ctl = tr = None

    # 27c: Cape Basin, the time domain: 720 hourly HR fields
    cape, cape_root = tmp / "cape", tmp / "cape_run"
    (cape / "sst_192x192").mkdir(parents=True)
    t0 = time.perf_counter()
    for i in range(CAPE_HOURS):
        field = 12.0 + 2.0 * _field(np.random.default_rng(27), 192, 192, i / 24.0)
        np.save(cape / f"sst_192x192/hr_sst_{i + 1:04d}.npy", field.astype(np.float32))
    say("27c Cape Basin fixture", fields=CAPE_HOURS, shape=[192, 192],
        bytes=_tree_bytes(cape), write_s=time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats(dev)
    with _TrainerCapture(profiled=2) as seen:
        tr, wall, counts = _train_launch(_args(CAPE_GROUPS, {
            "model.winograd": 4, "task.nepochs": 1, "dataset.dataset_root": str(cape),
            "platform.root": str(cape_root)}))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    add(counts)
    try:
        t = dict(tr.timers)
        rows = _csv_rows(tr)
        nts = len(tr.data_timestamps[TSet.Train])
        steady = seen.slices[1:2] + seen.slices[3:]
        steady_ms = 1e3 * sum(w for w, _ in steady) / max(sum(n for _, n in steady), 1)
        expected = _launches_of(tr)
        # the launcher's context again: the split of the batch starts, and
        # evaluate on the validation starts from the best checkpoint
        with ConfigContext("sres", model="rcan-10-20-64", **CAPE_GROUPS, **{
                "model.winograd": 4, "dataset.dataset_root": str(cape),
                "platform.root": str(cape_root)}):
            starts = tr.dataset.get_batch_time_coords(shuffle=False)
            split = {s.value: len(v) for s, v in ttsplit_times(starts).items()}
            _, losses = tr.evaluate(TSet.Validation, update_model=True, update_checkpoint=False)
        say("27c Cape Basin trainer epoch", batch_starts=len(starts), split=split, wall_s=wall,
            train_s=t["train"], steps=t["steps"], eval_steps=t.get("eval_steps", 0),
            rows=len(rows), csv=rows, ms_per_step=1e3 * t["train"] / t["steps"],
            ms_per_step_steady=steady_ms,
            load_s=t["load"], batch_load_s=t["assemble"], validation_s=t["valid"],
            peak_mem_gb=peak_gb, launches=counts, expected=expected,
            evaluate_valid=losses, **_host_share(t))
        _check_rows("27c", rows, nts + 2)
        if split["valid"] < 1 or counts != expected or min(counts.values()) <= 0:
            raise CheckFailed(f"27c: split {split}, launches {counts} != {expected}")
        if not losses or not all(math.isfinite(v) for v in losses.values()):
            raise CheckFailed(f"27c: evaluate on the validation set gave {losses}")
        seen.profile_line("27c Cape Basin trainer profile, one batch", steady_ms)
    finally:
        tr = seen = None

    # 27d: the zarr export of swot_20-20e through its launcher
    from sres_tpu_torch.data.swot import SWOTRawDataLoader
    from sres_tpu_torch.to_zarr import main as to_zarr_main
    from sres_tpu_torch.util.zarrlite import read_zarr
    t0 = time.perf_counter()
    store = to_zarr_main(_args(dict(SWOT_GROUPS, dataset="swot_20-20e"), {
        "dataset.dataset_root": str(fixture), "platform.root": str(tmp / "zarr_run")}))
    export_s = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        back = read_zarr(store)
        read_s = time.perf_counter() - t0
        loader = SWOTRawDataLoader(cfg().task)
        same = [_same_bits(back[i], loader.load_region_data(i).data)
                for i in loader.get_dset_time_indices()]
    finally:
        ConfigContext.deactivate()
    say("27d zarr export, swot_20-20e", store=Path(store).name, shape=list(back.shape),
        bytes=_tree_bytes(store), export_s=export_s, read_s=read_s, bit_equal=same)
    if back.shape[:2] != (SWOT_NTIMES, len(SWOT_VARS)) or not all(same):
        raise CheckFailed(f"27d: the zarr store {back.shape} does not read back as "
                          f"load_region_data: {same}")
    return launches


# ------------------------------------------------------------- 28 the zoo
# config/model/<name>.yaml as written (tests/test_torch_eval_step.py holds
# each copy to its file); the UNet with 4 temporal features, the width of
# the trainer's sin/cos day and year rows
ZOO_CFGS = {
    "vdsr": dict(name="vdsr", nfeatures=64, nlayers=4, loss_fn="l2", kernel_size=3,
                 res_scale=1.0, downscale_factors=[2, 2], ups_mode="bicubic"),
    "dbpn": dict(name="dbpn", nfeatures=128, depth=3, nprojectionfeatures=32, loss_fn="l2",
                 downscale_factors=[2, 2], ups_mode="bicubic"),
    "latticenet": dict(name="latticenet", nfeatures=64, ndiff=16, loss_fn="l2",
                       kernel_size=3, bias=True, downscale_factors=[2, 2],
                       ups_mode="bicubic"),
    "esrt": dict(name="esrt", nfeatures=32, nlayers=1, loss_fn="l2", kernel_size=3,
                 downscale_factors=[2, 2], ups_mode="bicubic"),
    "srdn": dict(name="srdn", nfeatures={"hidden": 64, "upscale": 128}, nlayers=16,
                 usmethod="replicate", loss_fn="l2",
                 kernel_size={"features": 3, "hidden": 3, "output": 9},
                 downscale_factors=[2, 2], ups_mode="bicubic"),
    "unet": dict(name="unet", nfeatures=64, nlayers=4, loss_fn="l2",
                 use_temporal_features=True, downscale_factors=[2, 2], ups_mode="bicubic"),
    "lapsrn": dict(name="lapsrn", nfeatures=128, loss_fn="l2", multiscale_loss=True,
                   downscale_factors=[2, 2], ups_mode="bicubic"),
    "mscnn": dict(name="mscnn", nfeatures=64, nlayers=4, loss_fn="l2", multiscale_loss=True,
                  downscale_factors=[2, 2], ups_mode="bicubic"),
}
ZOO_NTF, ZOO_TILES, ZOO_PAD = 4, 2, 7
# 28c: the launcher on a 1920² land-free region (100 HR tiles of 192²) of 2
# timeslices, one trained and one validated, at the task's batch 36: an
# epoch is 3 steps and its last batch holds 28 tiles of 36
ZOO_LAUNCH = ["--task", "synthetic-tiles-48", "--dataset", "synthetic", "--platform",
              "local", "--seed", "42", "dataset.image_size={y: 1920, x: 1920}",
              "dataset.ntimes=2", "dataset.nan_fraction=0.0",
              "task.ttsplit={train: 0.5, valid: 0.5, test: 0.0}", "task.nepochs=1"]
ZOO_CUTS = ("1920² land-free region (dataset.nan_fraction=0), 2 timeslices "
            "(split 0.5 / 0.5 / 0), batch 36: 3 steps, the last 28 of 36 valid")


def module_flops(model, *args) -> float:
    """Forward FLOP of ``model(*args)`` in its convs, transposed convs and
    linear layers (2 per multiply-add), counted from the shapes a forward
    hands them; ESRT's attention products are not counted."""
    import torch
    import torch.nn as nn
    total = [0.0]

    def hook(mod, inp, out):
        k = math.prod(getattr(mod, "kernel_size", (1,)))
        if isinstance(mod, nn.ConvTranspose2d):
            total[0] += 2.0 * inp[0].numel() * mod.out_channels * k / mod.groups
        elif isinstance(mod, nn.Conv2d):
            total[0] += 2.0 * out.numel() * mod.in_channels * k / mod.groups
        else:
            total[0] += 2.0 * out.numel() * mod.in_features
    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear))]
    try:
        with torch.no_grad():
            model(*args)
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def _levels(out):
    return out if isinstance(out, tuple) else (out,)


def _rel_levels(a, ref) -> float:
    return max(rel_err(x.cpu(), y.cpu()) for x, y in zip(_levels(a), _levels(ref)))


def _bn_stats(model):
    return {k: v.detach().float().cpu() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _zoo_correct(name, cfg, dev, seed, ntf):
    """28a: the same seeded weights on the card and the CPU in f32 (TF32
    off): the forward on ZOO_TILES tiles, one train step's loss, gradients
    and BN running statistics; the bf16 envelope; and one step on a batch
    of 72 with its last ZOO_PAD tiles zero-weight, held to a step on the
    65 valid tiles alone."""
    import torch
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import has_batch_norm
    from sres_tpu_torch.models.temporal import get_temporal_features
    from sres_tpu_torch.trainer.step import (build_optimizer, build_train_step, forward,
                                             make_step_config, prepare_inputs)
    tol = 1e-3 if name == "srdn" else 1e-4
    rng = np.random.default_rng(seed + 28)
    feats = get_temporal_features(np.arange(8.0))
    row = lambda n: torch.from_numpy(np.repeat(feats[3:4], n, 0)) if ntf else None
    models = {}
    for where, prec in (("card", "f32"), ("cpu", "f32"), ("card", "bf16"), ("cpu", "bf16")):
        m = build_model(cfg, 1, 1, prec, seed=seed, device=dev if where == "card" else "cpu",
                        temporal_features=ntf or None)
        models[where, prec] = m
    sd = models["card", "f32"].state_dict()
    for key, m in models.items():
        if key != ("card", "f32"):
            m.load_state_dict(sd)
    sc = make_step_config(TRAIN_TASK, cfg, has_batch_norm(models["card", "f32"]), ntf)
    hr = torch.from_numpy(smooth_fields(rng, ZOO_TILES, HR))
    outs = {}
    for (where, prec), m in models.items():
        d = dev if where == "card" else torch.device("cpu")
        lr = prepare_inputs(hr.to(d), sc)[0]
        m.eval()
        with torch.no_grad():
            t = row(ZOO_TILES)
            outs[where, prec] = tuple(o.float().cpu() for o in _levels(
                forward(m, lr, sc, temporal=None if t is None else t.to(d))))
    f32_fwd = _rel_levels(outs["card", "f32"], outs["cpu", "f32"])
    e_card = _rel_levels(outs["card", "bf16"], outs["card", "f32"])
    e_cpu = _rel_levels(outs["cpu", "bf16"], outs["cpu", "f32"])

    # one f32 train step on each, and on the CPU in f64 (the model's convs
    # and BatchNorm in f64 between its f32 input and output): loss,
    # gradients, BN running statistics
    ref = build_model(cfg, 1, 1, "f32", device="cpu", temporal_features=ntf or None)
    ref.load_state_dict(sd)
    ref.dtype = torch.float64
    models["ref", "f64"] = ref.double()
    res = {}
    for where, prec in (("card", "f32"), ("cpu", "f32"), ("ref", "f64")):
        m = models[where, prec]
        d = dev if where == "card" else torch.device("cpu")
        step = build_train_step(m, build_optimizer(m, TRAIN_TASK), sc)
        t = row(ZOO_TILES)
        met = step(hr.to(d), torch.ones(ZOO_TILES, device=d),
                   *(() if t is None else (t.to(d),)))
        # (ESRT's unused Scale gets no gradient)
        grads = {k: p.grad.detach().float().cpu() for k, p in m.named_parameters()
                 if p.grad is not None}
        res[where] = (float(met["mloss"]), grads, _bn_stats(m))
    (l_k, g_k, s_k), (l_c, g_c, s_c), (_, g_r, _) = res["card"], res["cpu"], res["ref"]
    if not set(g_k) == set(g_c) == set(g_r):
        raise CheckFailed(f"28a {name}: gradients of {sorted(set(g_k) ^ set(g_c))} on one side")
    # gradients against the model's largest: the card's f32 against the
    # CPU's, and each against the f64 reference; the gate is the envelope,
    # the card's distance from f64 within twice the CPU's f32 noise + tol
    # (a BatchNorm over few values, as UNet's 3×3 bottleneck at 2 tiles,
    # leaves the CPU's own f32 gradients ~1.4e-4·max from f64)
    gscale = max(float(g.abs().max()) for g in g_r.values())
    gdist = lambda a, b: max(float((a[k] - b[k]).abs().max()) for k in g_r) / gscale
    g_err, g_card64, g_cpu64 = gdist(g_k, g_c), gdist(g_k, g_r), gdist(g_c, g_r)
    s_err = max([float((s_k[k] - s_c[k]).abs().max() / s_c[k].abs().max()) for k in s_c],
                default=0.0)
    loss_err = abs(l_k - l_c) / abs(l_c)
    del models

    # padded batch: 72 with the last ZOO_PAD zero-weight (zero tiles, as the
    # trainer pads) against the 65 valid tiles alone, f32 on the card
    hr72 = torch.from_numpy(smooth_fields(rng, BATCH, HR))
    hr72[BATCH - ZOO_PAD:] = 0.0
    w72 = torch.ones(BATCH)
    w72[BATCH - ZOO_PAD:] = 0.0
    padded = {}
    for tag, (h, w) in (("padded", (hr72, w72)),
                        ("valid", (hr72[:BATCH - ZOO_PAD], w72[:BATCH - ZOO_PAD]))):
        m = build_model(cfg, 1, 1, "f32", device=dev, temporal_features=ntf or None)
        m.load_state_dict(sd)
        step = build_train_step(m, build_optimizer(m, TRAIN_TASK), sc)
        t = row(h.shape[0])
        met = step(h.to(dev), w.to(dev), *(() if t is None else (t.to(dev),)))
        padded[tag] = (float(met["sloss"]), _bn_stats(m))
        del m, step
    (sl_p, st_p), (sl_v, st_v) = padded["padded"], padded["valid"]
    pad_err = max([float((st_p[k] - st_v[k]).abs().max() / st_v[k].abs().max()) for k in st_v],
                  default=0.0)
    line = dict(model=name, tiles=ZOO_TILES, f32_forward_rel=f32_fwd, f32_step_loss_rel=loss_err,
                f32_grad_rel=g_err, f32_grad_card_vs_f64=g_card64,
                f32_grad_cpu_vs_f64=g_cpu64, f32_grad_bound=2 * g_cpu64 + tol,
                f32_bn_stats_rel=s_err, f32_tol=tol,
                bf16_card_rel=e_card, bf16_cpu_rel=e_cpu, bf16_bound=2 * e_cpu + 1e-4,
                padded_bn_stats_rel=pad_err, padded_bn_tol=1e-5, bn_buffers=len(st_v),
                padded_sloss=sl_p, valid_sloss=sl_v)
    say(f"28a {name} correctness", **line)
    ok = (max(f32_fwd, loss_err, s_err) <= tol and g_card64 <= 2 * g_cpu64 + tol
          and e_card <= 2 * e_cpu + 1e-4
          and pad_err <= 1e-5 and abs(sl_p - sl_v) <= 1e-5 * abs(sl_v)
          and math.isfinite(l_k))
    if not ok:
        raise CheckFailed(f"28a {name}: {line}")
    return sd


def _zoo_busy(fn):
    """One call of ``fn`` under torch.profiler between 64 + 64 marker
    kernels (``one_kernel``'s remedy: late in the script a capture loses
    its first device records): (device-busy ms, kernel rows), the markers
    left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            torch.cuda._sleep(1)
        fn()
        for _ in range(64):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and "spin_kernel" not in e.key]
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


def _zoo_timed(fn, n=NSTEP):
    """One warm-up call, then ``n`` calls timed one by one with CUDA
    events: their ms and the median."""
    import torch
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(n):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
    return statistics.median(ms), ms


def _zoo_served_trained(name, cfg, dev, seed, ntf, sd):
    """28b: bf16, three requests of 72 HR tiles through build_eval_step and
    three Adam steps (lr 1e-4) at batch 72 through build_train_step: ms,
    tiles/s, peak memory, FLOP and TF/s, the idle share and a device-time
    profile of one call each."""
    import torch
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import has_batch_norm
    from sres_tpu_torch.models.temporal import get_temporal_features
    from sres_tpu_torch.trainer.step import (build_eval_step, build_optimizer,
                                             build_train_step, make_step_config,
                                             prepare_inputs)
    m = build_model(cfg, 1, 1, "bf16", device=dev, temporal_features=ntf or None)
    m.load_state_dict(sd)
    sc = make_step_config(TRAIN_TASK, cfg, has_batch_norm(m), ntf)
    rng = np.random.default_rng(seed + 128)
    reqs = [torch.from_numpy(smooth_fields(rng, BATCH, HR)).to(dev) for _ in range(NREQ)]
    weight = torch.ones(BATCH, device=dev)
    extra = ((torch.from_numpy(np.repeat(get_temporal_features(np.arange(8.0))[3:4], BATCH, 0))
              .to(dev),) if ntf else ())
    lr0 = prepare_inputs(reqs[0], sc)[0]
    m.eval()
    fwd = module_flops(m, lr0.to(torch.bfloat16), *extra)
    out = {}
    for kind in ("serve", "train"):
        if kind == "serve":
            call = build_eval_step(m, sc)
            flops = fwd
        else:
            call = build_train_step(m, build_optimizer(m, TRAIN_TASK), sc)
            flops = 3.0 * fwd           # forward, the input and weight gradients
        i = [0]

        def run():
            r = call(reqs[i[0] % NREQ], weight, *extra)
            i[0] += 1
            return r
        torch.cuda.reset_peak_memory_stats(dev)
        med, ms = _zoo_timed(run)
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        busy, rows = _zoo_busy(run)
        res = dict(ms=med, ms_calls=ms, tiles_per_s=BATCH / (med / 1e3),
                   gflop=flops / 1e9, tflop_s=flops / (med / 1e3) / 1e12,
                   peak_mem_gb=peak, device_ms=busy,
                   device_idle_pct=100.0 * (1 - busy / med),
                   top=[dict(kernel=k[:70], ms=v, calls=n) for k, v, n in rows[:6]])
        say(f"28b {name} {kind}", batch=BATCH, gflop_per_tile_forward=fwd / BATCH / 1e9, **res)
        out[kind] = res
        if kind == "serve":
            met = run()[0]
            if not all(math.isfinite(float(v)) for v in met.values()):
                raise CheckFailed(f"28b {name}: non-finite served metrics {met}")
        else:
            losses = [float(run()["mloss"]) for _ in range(NSTEP)]
            if not all(math.isfinite(v) for v in losses):
                raise CheckFailed(f"28b {name}: non-finite losses {losses}")
        del call
    return out


def _zoo_launcher(name, cfg, dev, root, ntf):
    """28c: ``train.main`` on the synthetic task (one epoch, ZOO_CUTS), the
    first step against build_train_step bit for bit, the CSV, the BN
    buffers through the checkpoint, then ``infer_region`` of the
    best-validation checkpoint held against f32 in the bf16 envelope."""
    import torch
    from sres_tpu_torch.config import ConfigContext
    from sres_tpu_torch.data.inference_io import TSet
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.ops.assemble import assemble_tiles
    from sres_tpu_torch.train import main as train_main
    from sres_tpu_torch.trainer.checkpoints import read_checkpoint
    from sres_tpu_torch.trainer.step import build_eval_step
    over = [f"platform.root={root / name}"]
    t0 = time.perf_counter()
    with _TrainerCapture(profiled=-1) as seen:
        ctl = train_main(["--model", name] + ZOO_LAUNCH + over)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tr = ctl.trainer
    rows = _csv_rows(tr)
    _check_rows(f"28c {name}", rows, 2)
    nvalid = [int(b[1].sum()) for b in seen.batches]
    if nvalid != [36, 36, 28] or tr.step_config.ntemporal != ntf:
        raise CheckFailed(f"28c {name}: batches {nvalid}, ntemporal {tr.step_config.ntemporal}")
    ckpts = root / name / "results/checkpoints"
    (train_ck,) = ckpts.glob("*.train.ckpt")
    saved = read_checkpoint(str(train_ck))["model"]
    trained = tr.model.state_dict()
    buffers = [k for k in trained if "running_" in k or "num_batches" in k]
    same_buffers = all(torch.equal(saved[k], trained[k].cpu()) for k in buffers)
    first = seen.first_step(f"28c {name}", dev, cfg, TRAIN_TASK)
    del first, seen
    if not same_buffers:
        raise CheckFailed(f"28c {name}: the checkpoint's BN buffers differ from the model's")

    # infer_region of the best-validation checkpoint, held against f32
    with ConfigContext("sres", model=name, **REGION_GROUPS,
                       **_launch_overrides(ZOO_LAUNCH + over)):
        cv = tr.data_timestamps[TSet.Validation][0]
        t1 = time.perf_counter()
        served = tr.infer_region(cv, update_model=True)["SST"]["model"].data
        torch.cuda.synchronize()
        region_s = time.perf_counter() - t1
        m32 = build_model(cfg, 1, 1, "f32", device=dev, temporal_features=ntf or None)
        m32.load_state_dict(tr.model.state_dict())
        with _Serving(tr, m32):
            ref = tr.infer_region(cv, update_model=False)["SST"]["model"].data
        prep = tr._prepare_region_inputs(cv)
        gs = prep[1]
        hr, w, ids, scale, offset, *t = [a.to(dev) for a in prep[2:]]
        _, (lr, out, _, _) = build_eval_step(tr.model, tr.step_config)(hr, w, *t)
        step_panel = assemble_tiles((out * scale + offset)[:, 0], ids, gs, w).cpu().numpy()
        del m32
    e_region, e_step = _panel_err(served, ref), _panel_err(step_panel, ref)
    line = dict(model=name, cuts=ZOO_CUTS, wall_s=wall, steps=tr.timers["steps"],
                valid_tiles=nvalid, rows=rows, bn_buffers=len(buffers),
                checkpoint_bn_buffers_bit_equal=same_buffers, region_s=region_s,
                slots=int(gs["x"] * gs["y"]), bf16_region_rel=e_region,
                bf16_eval_step_rel=e_step, bound=2 * e_step + 1e-4)
    say(f"28c {name} launcher and region", **line)
    if not (e_region <= 2 * e_step + 1e-4 and np.isfinite(served).all()):
        raise CheckFailed(f"28c {name}: {line}")
    ConfigContext.deactivate()
    del ctl, tr


def _launch_overrides(args):
    """The dot-key overrides among launcher arguments, parsed as the
    launcher parses them."""
    from sres_tpu_torch.train import parse_overrides
    return parse_overrides([a for a in args if "=" in a and not a.startswith("-")])


def phase_zoo(dev, seed, root):
    """Phase 28: the eight zoo models of config/model at their published
    widths, bf16 on SST-tiles-48's shapes (48×48 LR, 1×192×192 HR): 28a
    correctness, 28b served and trained, 28c through the launcher and
    ``infer_region``; no kernel of the port launches."""
    _reset_all_launches()
    t0 = time.perf_counter()
    summary = {}
    for name, cfg in ZOO_CFGS.items():
        ntf = ZOO_NTF if cfg.get("use_temporal_features") else 0
        t_model = time.perf_counter()
        sd = _zoo_correct(name, cfg, dev, seed, ntf)
        summary[name] = _zoo_served_trained(name, cfg, dev, seed, ntf, sd)
        del sd
        _zoo_launcher(name, cfg, dev, root, ntf)
        summary[name]["s"] = time.perf_counter() - t_model
    launches = {k: v for k, v in _all_launches().items() if v}
    say("28 zoo summary", card=CARD, phase_s=time.perf_counter() - t0, kernel_launches=launches,
        **{f"{k}_{kind}_{m}": v[kind][m] for k, v in summary.items()
           for kind in ("serve", "train") for m in ("ms", "tiles_per_s", "tflop_s",
                                                    "peak_mem_gb", "device_idle_pct")},
        **{f"{k}_s": v["s"] for k, v in summary.items()})
    if launches:
        raise CheckFailed(f"28: the zoo launched the port's kernels: {launches}")
    return dict.fromkeys(_all_launches(), 0)


# ----------------------------------------------------- quantization (29)
# config/model/rcan-10-20-64.yaml, edsr.yaml and vdsr.yaml as they are:
# quantization switches the Winograd trunk off (sres_tpu/models/rcan.py
# :84-87, edsr.py:54-58)
Q_RCAN = {k: v for k, v in MODEL_CFG.items() if k != "winograd"}
Q_EDSR = {k: v for k, v in EDSR_CFG.items() if k != "winograd"}
Q_VDSR = dict(ZOO_CFGS["vdsr"])
# quantized convs a forward: RCAN 10·(2·20 + 1) + 1, EDSR 2·16 + 1, VDSR 4 - 1
Q_NCONV = {"rcan": 411, "edsr": 33, "vdsr": 3}
Q_ESTEPS = 2          # EDSR's and VDSR's int8_full steps
INT8_OPS_S = 1979e12  # H100 SXM data sheet: dense int8 tensor-core ops/s
Q_SRC = "sres_tpu_torch/ops/cuda/int8_conv.cu"
Q_REPLACES = {"q8_quantize": "no Pallas kernel: sres_tpu/ops/int8_conv.py:151 (XLA ops)",
              "s8_conv_fprop": "no Pallas kernel: sres_tpu/ops/int8_conv.py:160 (an XLA s8 conv)",
              "s8_conv_wgrad": "no Pallas kernel: sres_tpu/ops/int8_conv.py:195 (XLA s8 dots)"}
Q_KERNELS = {"q8_quantize": ["q8_absmax_kernel", "q8_quantize_kernel"],
             "s8_conv_fprop": ["s8_conv_fprop_kernel"],
             "s8_conv_wgrad": ["s8_conv_wgrad_kernel", "s8_wgrad_finish_kernel"]}


def int8_bound(nbytes: float, ops: float):
    """(least ms, what bounds it): bytes over HBM rate vs int8 tensor-core
    operations over the int8 peak."""
    t_b, t_o = nbytes / HBM_BYTES_S, ops / INT8_OPS_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def _device_busy_cuda(fn):
    """One call of ``fn`` under torch.profiler with device activity alone
    (a train step launches thousands of kernels; the host events of a full
    capture took ~20 s to gather): its device-busy ms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3


def phase_int8_kernels(dev, rng):
    """29a: the three int8 kernels against their twins at full width, bit
    for bit, timed in device time against their bounds and cuDNN."""
    import torch
    import torch.nn.functional as F
    from sres_tpu_torch.ops import int8_conv as q8
    cl = torch.channels_last
    x = _rand(rng, dev, SHAPE).contiguous(memory_format=cl)
    xb = x.bfloat16()
    w = _rand(rng, dev, (64, 64, 3, 3), 0.05)
    g = _rand(rng, dev, SHAPE).contiguous(memory_format=cl)
    bias = _rand(rng, dev, (64,), 0.05).bfloat16()
    xq2, sx2 = q8.quantize(xb, 2)
    sx_rows = q8._rows(sx2, 2, BATCH)
    res = {}

    cases = {"act_pk2_bf16": (xb, 2, 0, None, False), "act_pk1_f32": (x, 1, 0, None, False),
             "act_pk2_aqt_bf16": (xb, 2, 1, None, False), "act_pk1_aqt_f32": (x, 1, 1, None, False),
             "w_per_out": (w, 1, 0, None, False), "w_per_in_flipped": (w.transpose(0, 1), 1, 0, None, True),
             "w_per_out_aqt_bf16": (w.bfloat16(), 1, 1, None, False),
             "g_sx_whole": (g, None, 0, sx_rows, False)}
    q_err = 0.0
    for name, (t, grp, grid, pre, flip) in cases.items():
        q, sc = q8.quantize(t, grp, grid, pre=pre, flip=flip)
        qp, sp = q8.quantize_plain(t, grp, grid, pre=pre, flip=flip)
        err = max(float((q.float() - qp).abs().max()), float((sc - sp).abs().max()))
        q_err = max(q_err, err)
        say("29 kernel q8_quantize", case=name, shape=list(t.shape), groups=sc.numel(),
            bit_equal=err == 0.0, max_abs_err=err)
        if err != 0.0:
            raise CheckFailed(f"q8_quantize {name}: differs from its twin by {err}")
    modes = {"act_pk2_bf16": lambda: q8.quantize(xb, 2), "g_sx_whole_f32": lambda: q8.quantize(
        g, None, pre=sx_rows), "w_per_out": lambda: q8.quantize(w, 1)}
    t = {k: device_ms(f) for k, f in modes.items()}
    plain_ms = device_ms(lambda: q8.quantize_plain(xb, 2))
    bound, by = int8_bound(3 * xb.numel(), 0.0)             # bf16 read, s8 written
    res["q8_quantize"] = dict(max_abs_err=q_err, ms=t["act_pk2_bf16"], plain_ms=plain_ms,
                              bound_ms=bound, bound_by=by, library_ms=None, modes=t,
                              mode_bound_ms=dict(act_pk2_bf16=bound, g_sx_whole_f32=int8_bound(
                                  5 * g.numel(), 0.0)[0]))
    say("29 kernel q8_quantize timing", shape=list(SHAPE), device_ms=t, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by)

    # s8_conv_fprop at every instance the main path runs: RCAN's trunk
    # (int8_fused at pack 1 and 2, AQT's bf16 epilogue with bias at pack 2),
    # VDSR's 192² HR grid (cin 1 and 64), and int8_full's dx (f32 output:
    # the cotangent against the flipped, transposed weights) at 48² and 192²
    x1 = _rand(rng, dev, (BATCH, 1, HR, HR))
    x192 = _rand(rng, dev, (BATCH, 64, HR, HR)).bfloat16().contiguous(memory_format=cl)
    g192 = _rand(rng, dev, (BATCH, 64, HR, HR))
    w1 = _rand(rng, dev, (64, 1, 3, 3), 0.3)
    wt = w.transpose(0, 1)
    fused, aqt = q8.GRID_FUSED, q8.GRID_AQT
    bf16, f32 = torch.bfloat16, torch.float32
    # name: (activation, its grid and pack, weights, their grid, flip, bias,
    # output dtype, epilogue)
    fcases = {"48_pk1": (xb, fused, 1, w, fused, False, bias, bf16, q8.EPI_FUSED),
              "48_pk2": (xb, fused, 2, w, fused, False, bias, bf16, q8.EPI_FUSED),
              "48_pk2_aqt_bf16_bias": (xb, aqt, 2, w.bfloat16(), aqt, False, bias, bf16,
                                       q8.EPI_AQT16),
              "vdsr_cin1_192": (x1, fused, 1, w1, fused, False, bias, bf16, q8.EPI_FUSED),
              "vdsr_192": (x192, fused, 1, w, fused, False, bias, bf16, q8.EPI_FUSED),
              "dx_48_pk2_f32": (g, fused, 2, wt, fused, True, None, f32, q8.EPI_FUSED),
              "dx_192_pk1_f32": (g192, fused, 1, wt, fused, True, None, f32, q8.EPI_FUSED)}
    t, lib, bounds, plain, f_err = {}, {}, {}, {}, 0.0
    for name, (xt, xgrid, pk, wt_, wgrid, flip, bt, odt, epi) in fcases.items():
        xq, sx = q8.quantize(xt, pk, xgrid)
        wq, sw = q8.quantize(wt_, 1, wgrid, flip=flip)
        call = lambda: q8.conv_fprop(xq, wq, sx, pk, sw, bt, odt, epi)
        y = call()
        yp = q8.conv_fprop(xq.float(), wq.float(), sx, pk, sw, bt, odt, epi, plain=True)
        err = float((y.float() - yp.float()).abs().max())
        f_err = max(f_err, err)
        say("29 kernel s8_conv_fprop", case=name, shape=list(xt.shape), out_dtype=str(odt),
            epilogue=epi, bias=bt is not None, bit_equal=err == 0.0, max_abs_err=err,
            finite=bool(torch.isfinite(y.float()).all()))
        if err != 0.0:
            raise CheckFailed(f"s8_conv_fprop {name}: differs from its twin by {err}")
        t[name] = device_ms(call)
        xqb = xq.to(bf16).contiguous(memory_format=cl)
        wqb = wq.to(bf16).contiguous(memory_format=cl)
        lib[name] = device_ms(lambda: F.conv2d(xqb, wqb, bt, padding=1))
        m = xt.shape[0] * xt.shape[2] * xt.shape[3]
        bounds[name] = int8_bound(xq.numel() + wq.numel() + y.element_size() * m * 64,
                                  2.0 * m * 64 * 9 * xt.shape[1])
        if name == "48_pk2":
            plain["48_pk2"] = device_ms(lambda: q8.conv_fprop(
                xq.float(), wq.float(), sx, pk, sw, bt, odt, epi, plain=True))
        del xqb, wqb, y, yp
    res["s8_conv_fprop"] = dict(max_abs_err=f_err, ms=t["48_pk2"], plain_ms=plain["48_pk2"],
                                bound_ms=bounds["48_pk2"][0], bound_by=bounds["48_pk2"][1],
                                library_ms=lib["48_pk2"], modes=t,
                                mode_bound_ms={k: v[0] for k, v in bounds.items()},
                                mode_library_ms=lib)
    say("29 kernel s8_conv_fprop timing", device_ms=t, library_device_ms_cudnn_bf16=lib,
        bound_ms={k: v[0] for k, v in bounds.items()}, plain_ms=plain["48_pk2"])

    # s8_conv_wgrad: int8_full's dw at (72, 64, 48, 48), pack 2 (RCAN, EDSR),
    # and at VDSR's 192² at pack 1, cin 64 and cin 1
    sx192 = q8._rows(q8.quantize(x192, 1)[1], 1, BATCH)
    gq192, sgp192 = q8.quantize(g192, None, pre=sx192)
    gq, sgp = q8.quantize(g, None, pre=sx_rows)
    wcases = {"48_pk2": (xq2, gq, sgp, 2),
              "vdsr_192_pk1": (q8.quantize(x192, 1)[0], gq192, sgp192, 1),
              "vdsr_cin1_192_pk1": (q8.quantize(x1, 1)[0], gq192, sgp192, 1)}
    wt_ms, wt_lib, wt_bound, w_err = {}, {}, {}, 0.0
    for name, (xq, gqc, sgpc, pk) in wcases.items():
        ws = (64, xq.shape[1], 3, 3)
        call = lambda: q8.conv_wgrad(xq, gqc, ws, pk, sgpc, bf16)
        dw = call()
        dwp = q8.conv_wgrad(xq.float(), gqc.float(), ws, pk, sgpc, bf16, plain=True)
        err = float((dw - dwp).abs().max())
        w_err = max(w_err, err)
        say("29 kernel s8_conv_wgrad", case=name, shape=list(xq.shape), pack=pk,
            bit_equal=err == 0.0, max_abs_err=err, max_abs=float(dw.abs().max()))
        if err != 0.0:
            raise CheckFailed(f"s8_conv_wgrad {name}: differs from its twin by {err}")
        wt_ms[name] = device_ms(call)
        xqb = xq.to(bf16).contiguous(memory_format=cl)
        gqb = gqc.to(bf16).contiguous(memory_format=cl)
        wt_lib[name] = device_ms(lambda: torch.nn.grad.conv2d_weight(xqb, ws, gqb, padding=1))
        m = xq.shape[0] * xq.shape[2] * xq.shape[3]
        wt_bound[name] = int8_bound(xq.numel() + gqc.numel() + 4 * dw.numel(),
                                    2.0 * 9 * 64 * xq.shape[1] * m)
        del xqb, gqb, dw, dwp
    plain_ms = time_ms(lambda: q8.conv_wgrad(xq2.float(), gq.float(), (64, 64, 3, 3), 2, sgp,
                                             bf16, plain=True), iters=2, warmup=1)
    bound, by = wt_bound["48_pk2"]
    res["s8_conv_wgrad"] = dict(max_abs_err=w_err, ms=wt_ms["48_pk2"], plain_ms=plain_ms,
                                bound_ms=bound, bound_by=by, library_ms=wt_lib["48_pk2"],
                                modes=wt_ms, mode_bound_ms={k: v[0] for k, v in wt_bound.items()},
                                mode_library_ms=wt_lib)
    say("29 kernel s8_conv_wgrad timing", device_ms=wt_ms, plain_ms=plain_ms,
        bound_ms={k: v[0] for k, v in wt_bound.items()},
        library_device_ms_cudnn_bf16_wgrad=wt_lib)
    del x1, x192, g192, gq192

    # int8_fused's backward: cuDNN's bf16 convs on the kernels' and the twins'
    # operands, within a bf16 ulp of each other
    grads = []
    for plain in (False, True):
        xr = xb.detach().requires_grad_()
        wr = w.detach().requires_grad_()
        y = q8.Int8ConvFn.apply(xr, wr, bias, 2, torch.bfloat16, plain)
        y.backward(g.bfloat16())
        grads.append((xr.grad.float(), wr.grad.float()))
    e = [rel_err(a, b) for a, b in zip(grads[0], grads[1])]
    say("29 int8_fused backward kernels vs twins", dx_rel=e[0], dw_rel=e[1], bound=2.0 ** -7)
    if not max(e) <= 2.0 ** -7:
        raise CheckFailed(f"int8_fused backward: kernels vs twins {e}")
    for k, v in res.items():
        v["kernels"] = Q_KERNELS[k]
    return res


def _q_serve(name, model, sc, reqs, weight, want_nconv):
    """Three requests through build_eval_step: launches, finite outputs."""
    import torch
    from sres_tpu_torch.trainer.step import build_eval_step
    es = build_eval_step(model, sc)
    es(reqs[0], weight)
    torch.cuda.synchronize()
    _reset_all_launches()
    out = [es(hr, weight) for hr in reqs]
    torch.cuda.synchronize()
    launches = {k: v for k, v in _all_launches().items() if v}
    want = {"q8_quantize": 2 * NREQ * want_nconv, "s8_conv_fprop": NREQ * want_nconv}
    sl = [float(m["sloss"]) for m, _ in out]
    say(f"29 {name} serve", launches=launches, expected=want, sloss=sl,
        interp_sloss=[float(m["interp_sloss"]) for m, _ in out])
    if launches != want:
        raise CheckFailed(f"{name} serving launches {launches} != {want}")
    for m, (lr, y, tar, interp) in out:
        if not (all(math.isfinite(v) for v in sl) and tuple(y.shape) == (BATCH, 1, HR, HR)
                and bool(torch.isfinite(y).all())):
            raise CheckFailed(f"{name} serving: non-finite or misshapen output")
    return es, launches


def _q_train(name, model, sc, batch, weight, want, nstep):
    """``nstep`` Adam steps on one batch: launches a step, finite metrics."""
    import torch
    from sres_tpu_torch.trainer.step import build_optimizer, build_train_step
    step = build_train_step(model, build_optimizer(model, TRAIN_TASK), sc)
    total, losses = {}, []
    torch.cuda.reset_peak_memory_stats()
    for i in range(nstep):
        _reset_all_launches()
        met = step(batch, weight)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _all_launches().items() if v}
        vals = {k: float(v) for k, v in met.items()}
        say(f"29 {name} train step", step=i, **vals, launches=launches, expected=want)
        if not all(math.isfinite(v) for v in vals.values()):
            raise CheckFailed(f"{name} train step {i}: non-finite metrics {vals}")
        if launches != want:
            raise CheckFailed(f"{name} train step {i}: launches {launches} != {want}")
        losses.append(vals["mloss"])
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return step, total, losses, torch.cuda.max_memory_allocated() / 1e9


def _q_loss(model, sc, hr, weight):
    import torch
    from sres_tpu_torch.trainer.losses import sr_loss
    from sres_tpu_torch.trainer.step import prepare_inputs
    model.train()
    with torch.no_grad():
        lr, target = prepare_inputs(hr, sc)
        return sr_loss(model(lr), target, weight, sc.loss_fn)[1].float().reshape(1)


def _q_full_want(nconv, nrecompute, ndx):
    """int8_full's launches a step: the forward's convs, the recomputed
    groups', the dx convs and every weight gradient; two quantizations a
    forward conv, three a backward one (g, the flipped weights, g·sx), one
    where the input needs no gradient."""
    return {"q8_quantize": 2 * (nconv + nrecompute) + 3 * ndx + (nconv - ndx),
            "s8_conv_fprop": nconv + nrecompute + ndx, "s8_conv_wgrad": nconv}


def phase_int8_slice(dev, seed):
    """29b and 29c: RCAN-10-20-64 served under int8 and int8_fused and
    trained under int8_fused and int8_full (remat), each in turns with the
    bf16 direct trunk of the same weights; EDSR and VDSR served under
    int8_fused and trained under int8_full."""
    import torch
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.models.layers import set_plain_twins
    from sres_tpu_torch.trainer.step import build_eval_step, make_step_config
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 29)
    reqs = [torch.from_numpy(smooth_fields(rng, BATCH, HR)).to(dev) for _ in range(NREQ)]
    weight = torch.ones(BATCH, device=dev)
    sc = make_step_config(TASK_CFG, Q_RCAN)
    direct = build_model(Q_RCAN, 1, 1, "bf16", seed=seed, device=dev)
    sd = direct.state_dict()

    def quantized(mode, precision="bf16"):
        m = build_model(dict(Q_RCAN, quantization=mode), 1, 1, precision, device=dev)
        m.load_state_dict(sd)
        return m

    serve_launches, train_launches, summary = {}, {}, {}
    steps = {"direct": build_eval_step(direct, sc)}
    for mode in ("int8", "int8_fused"):
        steps[mode], la = _q_serve(f"rcan {mode}", quantized(mode), sc, reqs, weight,
                                   Q_NCONV["rcan"])
        for k, v in la.items():
            serve_launches[k] = serve_launches.get(k, 0) + v
    timing = _windows(lambda name, i: steps[name](reqs[i % NREQ], weight), tuple(steps), NREQ)
    for name in steps:
        torch.cuda.reset_peak_memory_stats(dev)
        steps[name](reqs[0], weight)
        torch.cuda.synchronize()
        busy = _device_busy_cuda(lambda: steps[name](reqs[0], weight))
        med = timing[name][0]
        summary[f"serve_{name}"] = dict(ms=med, tiles_per_s=BATCH / (med / 1e3),
                                        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                                        device_idle_pct=100.0 * (1 - busy / med))
        say(f"29 rcan serve timing {name}", windows_ms_per_request=timing[name][1],
            **summary[f"serve_{name}"])
    del steps

    # the loss of one batch: kernels and twins in bf16 against the twins in f32
    model = quantized("int8_fused")
    ref = quantized("int8_fused", "f32")
    set_plain_twins(ref, True)
    lk, lt = _q_loss(model, sc, reqs[0], weight), _q_loss(ref, sc, reqs[0], weight)
    del ref
    set_plain_twins(model, True)
    lp = _q_loss(model, sc, reqs[0], weight)
    set_plain_twins(model, False)
    e_k, e_p = rel_err(lk, lt), rel_err(lp, lt)
    say("29 rcan int8_fused loss vs twins", kernel_bf16=float(lk), twin_bf16=float(lp),
        twin_f32=float(lt), bf16_kernel_rel=e_k, bf16_plain_rel=e_p, bound=2 * e_p + 1e-4)
    if not e_k <= 2 * e_p + 1e-4:
        raise CheckFailed(f"rcan int8_fused loss outside the twins' envelope {e_k} > 2*{e_p}+1e-4")

    n = Q_NCONV["rcan"]
    wants = {"int8_fused": {"q8_quantize": 2 * n, "s8_conv_fprop": n},
             "int8_full": _q_full_want(n, n - 1, n)}
    tsteps, peaks = {}, {}
    for mode, want in wants.items():
        m = model if mode == "int8_fused" else quantized(mode)
        tsteps[mode], tot, losses, peaks[mode] = _q_train(f"rcan {mode}", m, sc, reqs[0], weight,
                                                          want, NSTEP)
        if not losses[-1] < losses[0]:
            raise CheckFailed(f"rcan {mode}: the loss did not fall over {NSTEP} steps: {losses}")
        for k, v in tot.items():
            train_launches[k] = train_launches.get(k, 0) + v
    from sres_tpu_torch.trainer.step import build_optimizer, build_train_step
    d = build_model(Q_RCAN, 1, 1, "bf16", device=dev)
    d.load_state_dict(sd)
    tsteps["direct"] = build_train_step(d, build_optimizer(d, TRAIN_TASK), sc)
    torch.cuda.reset_peak_memory_stats(dev)
    tsteps["direct"](reqs[0], weight)
    torch.cuda.synchronize()
    peaks["direct"] = torch.cuda.max_memory_allocated(dev) / 1e9
    timing = _windows(lambda name, i: tsteps[name](reqs[i % NREQ], weight), tuple(tsteps), 1)
    for name in tsteps:
        med = timing[name][0]
        busy = _device_busy_cuda(lambda: tsteps[name](reqs[0], weight))
        summary[f"train_{name}"] = dict(ms=med, tiles_per_s=BATCH / (med / 1e3),
                                        peak_mem_gb=peaks[name],
                                        device_idle_pct=100.0 * (1 - busy / med))
        say(f"29 rcan train timing {name}", windows_ms_per_step=timing[name][1],
            **summary[f"train_{name}"])
    del tsteps, model, d

    # EDSR and VDSR at their YAMLs: int8_fused served, int8_full trained
    for name, cfg in (("edsr", Q_EDSR), ("vdsr", Q_VDSR)):
        n = Q_NCONV[name]
        m = build_model(dict(cfg, quantization="int8_fused"), 1, 1, "bf16", seed=seed,
                        device=dev)
        csc = make_step_config(TASK_CFG, cfg)
        es, la = _q_serve(f"{name} int8_fused", m, csc, reqs, weight, n)
        for k, v in la.items():
            serve_launches[k] = serve_launches.get(k, 0) + v
        ms = time_ms(lambda: es(reqs[0], weight), iters=NREQ, warmup=0)
        mf = build_model(dict(cfg, quantization="int8_full"), 1, 1, "bf16", device=dev)
        mf.load_state_dict(m.state_dict())
        # VDSR's first conv takes the upsampled input, which needs no gradient
        ndx = n - 1 if name == "vdsr" else n
        step, tot, losses, peak = _q_train(f"{name} int8_full", mf, csc, reqs[0], weight,
                                           _q_full_want(n, 0, ndx), Q_ESTEPS)
        tms = time_ms(lambda: step(reqs[0], weight), iters=1, warmup=0)
        for k, v in tot.items():
            train_launches[k] = train_launches.get(k, 0) + v
        summary[f"{name}_serve_int8_fused"] = dict(ms=ms, tiles_per_s=BATCH / (ms / 1e3))
        summary[f"{name}_train_int8_full"] = dict(ms=tms, tiles_per_s=BATCH / (tms / 1e3),
                                                  peak_mem_gb=peak, losses=losses)
        say(f"29 {name} summary", serve_int8_fused=summary[f"{name}_serve_int8_fused"],
            train_int8_full=summary[f"{name}_train_int8_full"])
        del m, mf, es, step
    say("29 quantization summary", card=CARD, phase_s=time.perf_counter() - t0,
        serve_launches=serve_launches, train_launches=train_launches, **summary)
    return serve_launches, train_launches


def phase_int8(dev, rng, seed):
    """Phase 29: model.quantization on the s8 kernels."""
    t0 = time.perf_counter()
    kern = phase_int8_kernels(dev, rng)
    say("29a kernels done", phase_s=time.perf_counter() - t0)
    serve_launches, train_launches = phase_int8_slice(dev, seed)
    return kern, serve_launches, train_launches


def main() -> int:
    global CARD, T0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", type=int, choices=[28, 29], default=None,
                    help="run the toolchain phase and this phase alone, and print no "
                         "result line (a rehearsal of one phase)")
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

    t_all = T0 = time.perf_counter()
    build_s = phase_toolchain()
    if args.only == 28:
        root = Path(tempfile.mkdtemp(prefix="sres_zoo_"))
        try:
            phase_zoo(dev, args.seed, root)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        say("done", total_s=time.perf_counter() - t_all, build_s=build_s)
        return 0
    if args.only == 29:
        phase_int8(dev, rng, args.seed)
        say("done", total_s=time.perf_counter() - t_all, build_s=build_s)
        return 0
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
    root = Path(tempfile.mkdtemp(prefix="sres_real_data_"))
    try:
        real_data_launches = phase_real_data(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    root = Path(tempfile.mkdtemp(prefix="sres_zoo_"))
    try:
        zoo_launches = phase_zoo(dev, args.seed, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    q_kern, q_serve, q_train = phase_int8(dev, rng, args.seed)
    kern.update(q_kern)
    serve_launches.update(q_serve)
    launches.update(q_train)
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
             "wino_chain": (src, "sres_tpu/ops/pallas/winograd_conv.py:339"),
             **{k: (Q_SRC, v) for k, v in Q_REPLACES.items()}}
    # the CUDA kernels behind each window-attention entry
    fwd = ["wattn_fwd_core_kernel", "wattn_fwd_proj_kernel"]
    bwd = ["wattn_bwd_core_kernel", "wattn_bwd_proj_kernel", "sum_partials_kernel"]
    cuda_kernels = {"window_attention": dict(t=64, kernels=fwd),
                    "window_attention_bwd": dict(t=64, kernels=bwd),
                    "window_attention_t256": dict(t=256, kernels=fwd),
                    "window_attention_bwd_t256": dict(t=256, kernels=bwd)}
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=where[k][0], replaces=where[k][1],
             launches=launches.get(k, 0), serve_launches=serve_launches.get(k, 0),
             trainer_launches=trainer_launches.get(k, 0),
             region_launches=region_launches.get(k, 0),
             real_data_launches=real_data_launches.get(k, 0),
             zoo_launches=zoo_launches.get(k, 0), **kern[k],
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
