"""A/B timing of the fused group's direct conv and weight gradient of two
checkouts on one card.

    python sres_tpu_torch/probes/fg_ab.py [--root DIR] [--label NAME]

Imports ``sres_tpu_torch`` from DIR (the root of a checkout; by default the
one holding this file; run the file by its path, so that no other copy of
the package is imported first), builds its kernels there, and times, in bf16
at the flagship shape (72, 64, 48, 48), ``fgroup_conv`` in the five modes a
fused training step calls it in: ``relu`` (conv1: bias, ReLU), ``f32_partials``
(conv2: bias, f32 output, CA partials), ``residual`` (the trailing conv: the
group skip), ``dgrad_mask`` (conv2's adjoint: CA prologue, ReLU mask,
partials) and ``dgrad_carry`` (conv1's adjoint: carried cotangent and the
group skip); and ``fgroup_wgrad`` in its three: ``plain``, ``prologue``
(g·gate + ds) and ``db_part`` (db from a conv's partials). Device time: a
``torch.cuda._sleep`` holds the stream while the host queues 20 calls, then
CUDA events time them (so the wrapper's host cost is not in the reading);
two readings each, after 3 warm-up calls. Operands come from a fixed numpy
seed, so two checkouts time the same inputs. Prints one JSON line with the
card's name and power limit.

To compare a change with its parent, unpack the parent (``git archive``)
into a git-ignored directory and run both in turns on one card: parent,
change, change, parent. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

SHAPE = (72, 64, 48, 48)
SLEEP_CYCLES = 50_000_000      # about 27 ms: longer than queueing 20 calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import sres_tpu_torch
    if not Path(sres_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"sres_tpu_torch came from {sres_tpu_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from sres_tpu_torch.ops import cuda
    from sres_tpu_torch.ops import fused_group as fg
    cuda.load()
    dev = torch.device("cuda")
    cl = torch.channels_last

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

    rng = np.random.default_rng(10)
    f32 = lambda *s, sc=1.0: torch.from_numpy(
        (rng.normal(size=s) * sc).astype(np.float32)).to(dev)
    x, g = (f32(*SHAPE).bfloat16().contiguous(memory_format=cl) for _ in range(2))
    m = torch.relu(f32(*SHAPE)).bfloat16().contiguous(memory_format=cl)
    wk = fg.conv_weights(f32(64, 64, 3, 3, sc=0.04), torch.bfloat16)
    b = f32(64, sc=0.04)
    gate, ds = f32(SHAPE[0], 64).sigmoid(), f32(SHAPE[0], 64, sc=1e-2)
    part = f32(SHAPE[0], 18, 64)
    conv = {"relu": lambda: fg.fgroup_conv(x, wk, b, relu=True),
            "f32_partials": lambda: fg.fgroup_conv(x, wk, b, out_dtype=torch.float32,
                                                   partials=True),
            "residual": lambda: fg.fgroup_conv(x, wk, b, res=g),
            "dgrad_mask": lambda: fg.fgroup_conv(x, wk, gate=gate, ds=ds, mask=m,
                                                 partials=True),
            "dgrad_carry": lambda: fg.fgroup_conv(x, wk, res=g, res2=m)}
    wgrad = {"plain": lambda: fg.fgroup_wgrad(x, g),
             "prologue": lambda: fg.fgroup_wgrad(x, g, gate=gate, ds=ds),
             "db_part": lambda: fg.fgroup_wgrad(x, g, db_part=part)}
    out = {f"conv {k}": [ms(f) for _ in range(2)] for k, f in conv.items()}
    out.update({f"wgrad {k}": [ms(f) for _ in range(2)] for k, f in wgrad.items()})
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(label=args.label, root=str(root), card=card, shape=SHAPE,
                          bf16_device_ms=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
