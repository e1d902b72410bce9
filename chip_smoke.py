#!/usr/bin/env python3
"""Card smoke test of the PyTorch/H100 port (``sres_tpu_torch``).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card, ``nvcc`` and this checkout; imports no JAX and no YAML.
Phases, one line each (every line carries the card's name and power limit):

1. toolchain: torch / CUDA / nvcc versions, the kernel build time;
2. kernel (a), the Winograd conv, against its plain twin at (72, 64, 48, 48),
   m ∈ {2, 4}, ReLU on/off, with and without the residual epilogue;
3. kernel (b), channel attention + block skip, against its plain twin;
4. one full residual group (20 RCABs + trailing conv, m=4, batch 72);
5. the serving slice: RCAN-10-20-64 ×4 with ``winograd: 4``, bf16 compute,
   served through build_model → build_eval_step for three requests of 72
   HR tiles at 1×192×192, compared with the same model on the plain twins,
   timed against the plain twins and the direct (cuDNN) trunk, and profiled
   (device time by kernel for one request of the kernel and direct paths);
6. kernel (c), the conv backward, against its plain twin at (72, 64, 48,
   48), m ∈ {2, 4}, in its four modes: per-conv adjoint, ReLU gate, CA
   prologue into an f32 dx, ReLU gate accumulated into an f32 buffer;
7. kernel (d), the channel-attention backward, against its plain twin;
8. one residual group's backward (20 RCABs + trailing conv, m=4, b72): the
   gradients of sum(y·G) and the stash, kernels against plain twins;
9. the train slice: the same model through build_model → build_optimizer →
   build_train_step (Adam, lr 1e-4, b72, 1×192×192 HR tiles): one step's
   loss and gradients against the plain twins, three Adam steps with their
   launch counts, ms/step and trained tiles/s against the direct cuDNN
   trunk under autograd, peak memory and a device-time profile of a step.

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
exists (cuDNN's conv and conv backward); the port never calls it.

The last three lines are a JSON object describing every kernel of the path
(``launches`` counted over the train slice's three steps only), the card's
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


def profile_device(label, fn, top: int = 12) -> float:
    """Device time by kernel name for one call of ``fn`` (torch.profiler,
    CUPTI); prints the table and returns the device-busy ms."""
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
    say(label, device_ms_total=total,
        top=[dict(kernel=k[:90], ms=ms, calls=n) for k, ms, n in rows[:top]])
    return total


# --------------------------------------------------------------- phases
def phase_toolchain():
    import torch
    from sres_tpu_torch.ops import cuda
    nvcc = cuda.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True
                         ).stdout.strip().splitlines()[-1]
    t0 = time.perf_counter()
    cuda.load()
    ptxas = [ln.strip() for ln in cuda.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    say("1 toolchain", python=platform.python_version(), torch=torch.__version__,
        cuda=torch.version.cuda, nvcc=ver, ninja=shutil.which("ninja"),
        build_s=cuda.build_seconds, load_s=time.perf_counter() - t0,
        ptxas=ptxas)
    return cuda.build_seconds


def phase_conv(dev, rng):
    import torch
    import torch.nn.functional as F
    from sres_tpu_torch.ops.winograd import transform_weights
    from sres_tpu_torch.ops.winograd_conv import wino_conv, wino_conv_plain
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
    u4 = transform_weights(w, 4).bfloat16()
    ms = time_ms(lambda: wino_conv(xb, u4, b, 4, True))
    plain_ms = time_ms(lambda: wino_conv_plain(xb, u4, b, 4, True))
    ms_f32 = time_ms(lambda: wino_conv(x, u4.float(), b, 4, True))
    wb, bb = w.bfloat16(), b.bfloat16()
    library_ms = time_ms(lambda: F.conv2d(xb, wb, bb, padding=1))
    # x read, y written (bf16), U (bf16) and the f32 bias read
    bound = bound_ms(2 * 2 * xb.numel() + 2 * u4.numel() + 4 * c, tap_flops(SHAPE, 4))
    say("2 kernel wino_conv timing", shape=SHAPE, m=4, dtype="bf16", ms=ms,
        plain_ms=plain_ms, f32_ms=ms_f32, bound_ms=bound,
        library_ms_cudnn_conv2d=library_ms)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=library_ms)


def phase_ca(dev, rng):
    import torch
    from sres_tpu_torch.ops.winograd_conv import ca_skip, ca_skip_plain
    c, hid = SHAPE[1], SHAPE[1] // MODEL_CFG["cbottleneck"]
    cl = dict(memory_format=torch.channels_last)
    q = torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32)).to(dev).contiguous(**cl)
    r = (torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32)).to(dev)
         + 0.3).contiguous(**cl)
    ws = [torch.from_numpy(rng.uniform(-a, a, s).astype(np.float32)).to(dev)
          for a, s in ((1 / 8, (hid, c)), (1 / 8, (hid,)),
                       (1 / math.sqrt(hid), (c, hid)), (1 / math.sqrt(hid), (c,)))]
    qb, rb = q.bfloat16(), r.bfloat16()
    out = check_pair("ca_skip", ca_skip(q, r, *ws), ca_skip_plain(q, r, *ws),
                     ca_skip(qb, rb, *ws), ca_skip_plain(qb, rb, *ws))
    torch.cuda.synchronize()
    say("3 kernel ca_skip", **out)
    ms = time_ms(lambda: ca_skip(qb, rb, *ws))
    plain_ms = time_ms(lambda: ca_skip_plain(qb, rb, *ws))
    # q and r read, out written (bf16); the MLP's few thousand MACs
    bound = bound_ms(3 * 2 * qb.numel(), 0.0)
    say("3 kernel ca_skip timing", shape=SHAPE, dtype="bf16", ms=ms, plain_ms=plain_ms,
        bound_ms=bound)
    return dict(max_abs_err=out["bf16_vs_plain_abs"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None)


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
    from sres_tpu_torch.models.wino_blocks import set_plain_twins
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
            "wino_conv_bwd": 0, "ca_skip_bwd": 0}
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
    for m in (2, 4):
        u = transform_weights(w, m)
        ys[m] = wino_conv_plain(x, u, b, m, relu=True)      # a ReLU output to gate by
        for mode in ("adjoint", "relu", "ca", "accum"):
            def run(fn, dt):
                kw = {}
                if mode in ("relu", "accum"):
                    kw["y"] = ys[m].to(dt)
                if mode == "ca":
                    kw.update(gate=gate, ds=ds)
                if mode == "accum":
                    kw["dprev"] = prev.clone()
                return fn(g if mode in ("ca", "accum") else g.to(dt), x.to(dt), u, m, **kw)
            outs = [run(fn, dt) for fn, dt in ((wino_conv_bwd, f32), (wino_conv_bwd_plain, f32),
                                               (wino_conv_bwd, bf16), (wino_conv_bwd_plain, bf16))]
            torch.cuda.synchronize()
            for i, name in enumerate(("dx", "dU", "db")):
                out = check_pair(f"m{m}_{mode}_{name}", *(o[i] for o in outs))
                say("6 kernel wino_conv_bwd", **out)
                if m == 4:
                    worst = max(worst, out["bf16_vs_plain_abs"])
            del outs
    u4 = transform_weights(w, 4).bfloat16()
    xb, gb, yb, wb = x.bfloat16(), g.bfloat16(), ys[4].bfloat16(), w.bfloat16()
    ms = time_ms(lambda: wino_conv_bwd(gb, xb, u4, 4, y=yb))
    plain_ms = time_ms(lambda: wino_conv_bwd_plain(gb, xb, u4, 4, y=yb), iters=3, warmup=1)
    ca_ms = time_ms(lambda: wino_conv_bwd(g, xb, u4, 4, gate=gate, ds=ds))
    acc = prev.clone()
    accum_ms = time_ms(lambda: wino_conv_bwd(g, xb, u4, 4, y=yb, dprev=acc))
    library_ms = time_ms(lambda: torch.ops.aten.convolution_backward(
        gb, xb, wb, [c], [1, 1], [1, 1], [1, 1], False, [0, 0], 1, [True, True, True]))
    # g, x, y read and dx written (bf16); U read (bf16); dU and db written (f32)
    nbytes = 4 * 2 * xb.numel() + 2 * u4.numel() + 4 * (u4.numel() + c)
    bound = bound_ms(nbytes, 2 * tap_flops(SHAPE, 4))      # dV and dU products
    say("6 kernel wino_conv_bwd timing", shape=SHAPE, m=4, dtype="bf16", mode="relu",
        ms=ms, plain_ms=plain_ms, ca_mode_ms=ca_ms, accum_mode_ms=accum_ms,
        bound_ms=bound, library_ms_cudnn_convolution_backward=library_ms)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=library_ms)


def phase_ca_bwd(dev, rng):
    import torch
    from sres_tpu_torch.ops.winograd_conv import ca_skip_bwd, ca_skip_bwd_plain
    c, hid = SHAPE[1], SHAPE[1] // MODEL_CFG["cbottleneck"]
    da, c2 = _rand(rng, dev, SHAPE), _rand(rng, dev, SHAPE, shift=0.3)
    ws = [torch.from_numpy(rng.uniform(-a, a, s).astype(np.float32)).to(dev)
          for a, s in ((1 / 8, (hid, c)), (1 / 8, (hid,)),
                       (1 / math.sqrt(hid), (c, hid)), (1 / math.sqrt(hid), (c,)))]
    c2b = c2.bfloat16()
    outs = [fn(da, cc, *ws) for fn, cc in ((ca_skip_bwd, c2), (ca_skip_bwd_plain, c2),
                                           (ca_skip_bwd, c2b), (ca_skip_bwd_plain, c2b))]
    torch.cuda.synchronize()
    worst = 0.0
    for i, name in enumerate(("gate", "ds", "dcaw1", "dcab1", "dcaw2", "dcab2")):
        out = check_pair(f"ca_skip_bwd_{name}", *(o[i] for o in outs))
        say("7 kernel ca_skip_bwd", **out)
        worst = max(worst, out["bf16_vs_plain_abs"])
    ms = time_ms(lambda: ca_skip_bwd(da, c2b, *ws))
    plain_ms = time_ms(lambda: ca_skip_bwd_plain(da, c2b, *ws))
    # da (f32) and c2 (bf16) read; the per-sample outputs are 37 KB
    bound = bound_ms(4 * da.numel() + 2 * c2b.numel(), 0.0)
    say("7 kernel ca_skip_bwd timing", shape=SHAPE, dtype="bf16", ms=ms,
        plain_ms=plain_ms, bound_ms=bound)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=None)


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
    from sres_tpu_torch.models.wino_blocks import set_plain_twins
    from sres_tpu_torch.ops import winograd_conv as wc
    from sres_tpu_torch.ops.winograd import transform_weights
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
            "wino_conv_bwd": nconv, "ca_skip_bwd": nl * nb}
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
        fresh = torch.equal(body_conv._u(torch.bfloat16), u_now)
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
    busy = {name: profile_device(f"9 train profile {name}",
                                 lambda: steps[name](batches[0], weight), top=14)
            for name in ("kernel", "direct")}
    say("9 train summary", kernel_ms_per_step=out["kernel"],
        direct_ms_per_step=out["direct"],
        kernel_device_idle_pct=100.0 * (1 - busy["kernel"] / out["kernel"]),
        direct_device_idle_pct=100.0 * (1 - busy["direct"] / out["direct"]),
        peak_mem_gb_kernel=peak_gb, peak_mem_gb_direct_step=peak_direct_gb)
    return total


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
    say("done", total_s=time.perf_counter() - t_all, build_s=build_s)

    src = "sres_tpu_torch/ops/cuda/winograd.cu"
    bwd_src = "sres_tpu_torch/ops/cuda/winograd_bwd.cu"
    where = {"wino_conv": (src, "sres_tpu/ops/pallas/winograd_conv.py:81"),
             "ca_skip": (src, "sres_tpu/ops/pallas/winograd_conv.py:454"),
             "wino_conv_bwd": (bwd_src, "sres_tpu/ops/pallas/winograd_conv.py:212"),
             "ca_skip_bwd": (bwd_src, "sres_tpu/ops/pallas/wino_group_grad.py:324")}
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=where[k][0], replaces=where[k][1],
             launches=launches[k], serve_launches=serve_launches[k], **kern[k])
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
