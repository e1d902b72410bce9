"""A/B timing of the Winograd conv adjoint of two checkouts on one card.

    python sres_tpu_torch/probes/wino_bwd_ab.py [--root DIR] [--label NAME]

Imports ``sres_tpu_torch`` from DIR (the root of a checkout; by default the
one holding this file; run the file by its path, so that no other copy of
the package is imported first), builds its kernels there, and times its
``wino_conv_bwd`` in bf16 at the flagship shape (72, 64, 48, 48), m = 4, in
each mode a training step calls it in: ``relu`` (bf16 cotangent, ReLU gate,
bf16 dx: every trailing conv), ``ca`` (f32 cotangent, channel-attention
prologue, f32 dx: RCAN's conv2), ``accum`` (f32 cotangent, ReLU gate, added
into an f32 dprev: conv1 on RCAN and EDSR) and ``f32g`` (f32 cotangent, f32
dx: EDSR's conv2); and ``relu`` at m = 2. CUDA events over 20 back-to-back
calls after 3 warm-up calls, two readings each. Operands come from a fixed
numpy seed, so two checkouts time the same inputs. Prints one JSON line with
the card's name and power limit.

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
    from sres_tpu_torch.ops import winograd_conv as twc
    from sres_tpu_torch.ops.winograd import transform_weights
    cuda.load()
    dev = torch.device("cuda")
    cl = torch.channels_last

    def ms(fn, iters=20):
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

    rng = np.random.default_rng(8)
    f32 = lambda *s, sc=1.0: torch.from_numpy(
        (rng.normal(size=s) * sc).astype(np.float32)).to(dev)
    x, g, prev = (f32(*SHAPE).contiguous(memory_format=cl) for _ in range(3))
    w = f32(64, 64, 3, 3, sc=0.04)
    gate, ds = f32(SHAPE[0], 64).sigmoid(), f32(SHAPE[0], 64, sc=1e-3)
    xb, gb = x.bfloat16(), g.bfloat16()
    out = {}
    for m, modes in ((4, ("relu", "ca", "accum", "f32g")), (2, ("relu",))):
        u = transform_weights(w, m).bfloat16()
        yb = twc.wino_conv(xb, u, None, m, relu=True)
        acc = prev.clone(memory_format=cl)
        calls = {"relu": lambda: twc.wino_conv_bwd(gb, xb, u, m, y=yb),
                 "ca": lambda: twc.wino_conv_bwd(g, xb, u, m, gate=gate, ds=ds),
                 "accum": lambda: twc.wino_conv_bwd(g, xb, u, m, y=yb, dprev=acc),
                 "f32g": lambda: twc.wino_conv_bwd(g, xb, u, m)}
        for mode in modes:
            out[f"m{m} {mode}"] = [ms(calls[mode]) for _ in range(2)]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(label=args.label, root=str(root), card=card, shape=SHAPE,
                          bf16_ms=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
