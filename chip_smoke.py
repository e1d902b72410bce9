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
5. the slice: RCAN-10-20-64 ×4 with ``winograd: 4``, bf16 compute, served
   through build_model → build_eval_step for three requests of 72 HR tiles
   at 1×192×192, compared with the same model on the plain twins, timed
   against the plain twins and the direct (cuDNN) trunk, and profiled
   (device time by kernel for one request of the kernel and direct paths).

Tolerances: f32 max|kernel − plain| ≤ 3e-5·max|plain| (group 1e-4); bf16
rel_err(kernel_bf16, plain_f32) ≤ 2·rel_err(plain_bf16, plain_f32) + 1e-4,
where rel_err(a, b) = max|a − b| / max|b| (the envelope logic of
tests/test_winograd.py:test_winograd_bf16_noise_envelope).

The last three lines are a JSON object describing every kernel of the path
(``launches`` counted over the slice's three requests only), the card's
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
BATCH, HR, NREQ = 72, 192, 3
SHAPE = (BATCH, 64, 48, 48)

F32_TOL, GROUP_F32_TOL = 3e-5, 1e-4


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
    res = dict(case=name, f32_err=e32, f32_bound=b32, bf16_kernel_rel=e_k,
               bf16_plain_rel=e_p, bf16_bound=2 * e_p + 1e-4,
               bf16_vs_plain_abs=float((kbf.float() - pbf.float()).abs().max()))
    if not (e32 <= b32 and e_k <= 2 * e_p + 1e-4):
        raise CheckFailed(f"{name}: {res}")
    return res


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


def profile_request(name, eval_step, hr, weight, top: int = 12) -> None:
    """Device time by kernel name for one request (torch.profiler, CUPTI)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eval_step(hr, weight)
        torch.cuda.synchronize()
    # device-side events only: a CPU op's device time repeats its kernels'
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    say(f"5 slice profile {name}", device_ms_total=total,
        top=[dict(kernel=k[:90], ms=ms, calls=n) for k, ms, n in rows[:top]])


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
    say("2 kernel wino_conv timing", shape=SHAPE, m=4, dtype="bf16", ms=ms,
        plain_ms=plain_ms, f32_ms=ms_f32)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms)


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
    say("3 kernel ca_skip timing", shape=SHAPE, dtype="bf16", ms=ms, plain_ms=plain_ms)
    return dict(max_abs_err=out["bf16_vs_plain_abs"], ms=ms, plain_ms=plain_ms)


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

    model = build_model(MODEL_CFG, 1, 1, precision="bf16", seed=seed).to(dev)
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
    want = {"wino_conv": NREQ * (nl * (2 * nb + 1) + 1), "ca_skip": NREQ * nl * nb}
    say("5 slice launches", launches=launches, expected=want)
    if launches != want:
        raise CheckFailed(f"kernel launches {launches} != expected {want}")

    # the same request through the plain twins (bf16), and the f32 truth
    out_k = results[0][1][1]
    set_plain_twins(model, True)
    out_p = eval_step(reqs[0], weight)[1][1]
    ref = build_model(MODEL_CFG, 1, 1, precision="f32").to(dev)
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
    direct = build_model(dict(MODEL_CFG, winograd=None), 1, 1, "bf16").to(dev)
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
        profile_request(name, steps[name], reqs[0], weight)
    return launches


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
    launches = phase_slice(dev, args.seed)
    say("done", total_s=time.perf_counter() - t_all, build_s=build_s)

    src = "sres_tpu_torch/ops/cuda/winograd.cu"
    replaces = {"wino_conv": "sres_tpu/ops/pallas/winograd_conv.py:81",
                "ca_skip": "sres_tpu/ops/pallas/winograd_conv.py:454"}
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=src, replaces=replaces[k],
             launches=launches[k], **kern[k])
        for k in ("wino_conv", "ca_skip")]}))
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
