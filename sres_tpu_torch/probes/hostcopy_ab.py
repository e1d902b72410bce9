"""A/B of the train step with its constant matrices kept on the card
against the same step copying them from pageable host memory at every use,
as the port did before it kept them: the two resize matrices of each
bicubic resize (``ops/resize.py:device_matrix``, four a step) and the
Winograd G of each weight transform and weight-gradient untransform
(``ops/winograd.py:device_g``, 432 a step at RCAN-10-20-64). Each such copy
waits for the stream's queued work.

    python -m sres_tpu_torch.probes.hostcopy_ab     (on the card)

RCAN-10-20-64 with ``winograd: 4`` in bf16, Adam at lr 1e-4, batch 72 of
1×192×192 HR tiles (chip_smoke.py phase 9's step), one model: windows of
2 steps timed by CUDA events in the order copy, kept, kept, copy, and so
on, five of each (wall per step: what the host and the card take
together), and one
step of each under torch.profiler, whose host-to-device copies are
counted. Prints one JSON line with the card's name and power limit. Needs
a CUDA card and nvcc.
"""
from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np

MODEL_CFG = dict(name="rcan", nlayers=10, nblocks=20, nfeatures=64, cbottleneck=2,
                 loss_fn="l2", kernel_size=3, res_scale=1.0, batch_norm=False, bias=True,
                 downscale_factors=[2, 2], ups_mode="bicubic", lane_pack=2, winograd=4)
TASK = dict(input_variables=["SST"], target_variables=["SST"], lr=1e-4,
            downsample_mode="cubic", upsample_mode="cubic")
BATCH, HR = 72, 192


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sres_tpu_torch.models import build_model
    from sres_tpu_torch.ops import resize, winograd
    from sres_tpu_torch.trainer.step import (build_optimizer, build_train_step,
                                             make_step_config)
    if not torch.cuda.is_available():
        raise SystemExit("hostcopy_ab needs a CUDA card")
    dev = torch.device("cuda")
    kept = (resize.device_matrix, winograd.device_g)
    copied = (lambda i, o, mode, scale, device, align_corners=False:
              torch.from_numpy(resize.resize_matrix(i, o, mode, scale,
                                                    align_corners)).to(device),
              lambda m, device: torch.from_numpy(winograd.MATS[m][1]).to(device))

    def use(mode):
        resize.device_matrix, winograd.device_g = kept if mode == "kept" else copied

    model = build_model(MODEL_CFG, 1, 1, "bf16", seed=0, device="cuda")
    step = build_train_step(model, build_optimizer(model, TASK), make_step_config(TASK, MODEL_CFG))
    rng = np.random.default_rng(0)
    hr = torch.from_numpy(rng.normal(size=(BATCH, 1, HR, HR)).astype(np.float32)).to(dev)
    weight = torch.ones(BATCH, device=dev)

    def window(mode, n=2):
        use(mode)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            step(hr, weight)
        e.record()
        e.synchronize()
        return s.elapsed_time(e) / n

    for mode in ("kept", "copy"):
        window(mode, 1)                                   # warm-up
    ms = {}
    for mode in ("copy", "kept", "kept", "copy") * 2 + ("copy", "kept"):
        ms.setdefault(mode, []).append(window(mode))
    htod = {}
    for mode in ("copy", "kept"):
        use(mode)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(hr, weight)
            torch.cuda.synchronize()
        htod[mode] = sum(e.count for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA and e.key.startswith("Memcpy HtoD"))
    use("kept")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(probe="hostcopy_ab", card=card, windows_ms_per_step=ms,
                          median_ms_per_step={k: statistics.median(v) for k, v in ms.items()},
                          htod_copies_per_step=htod)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
