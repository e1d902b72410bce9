"""A/B timing of the window-attention kernels of two checkouts on one card.

    python sres_tpu_torch/probes/wattn_ab.py [--root DIR] [--label NAME]

Imports ``sres_tpu_torch`` from DIR (the root of a checkout; by default the
one holding this file; run the file by its path, so that no other copy of
the package is imported first), builds its kernels there, and times its
``window_attention_bwd`` and ``window_attention`` in bf16 at SwinIR's
shape (1728 windows of T = 64) and SwinIR-w16's (432 windows of T = 256),
C 64, 4 heads, unshifted and shifted (the 96×96 tile's group mask): CUDA
events over 20 back-to-back calls after 3 warm-up calls, two readings
each. Operands come from a fixed numpy seed, so two checkouts time the
same inputs. Prints one JSON line with the card's name and power limit.

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

SHAPES = ((8, 1728), (16, 432))   # (window side, windows): batch 12 of 96×96 tiles


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
    from sres_tpu_torch.models.swinir import shift_attn_mask
    from sres_tpu_torch.ops import cuda
    from sres_tpu_torch.ops import window_attention as twa
    cuda.load()
    dev = torch.device("cuda")

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

    out = {}
    for side, nw in SHAPES:
        t = side * side
        rng = np.random.default_rng(side)
        f32 = lambda *s, sc=1.0: torch.from_numpy(
            (rng.normal(size=s) * sc).astype(np.float32)).to(dev)
        x, g = f32(nw, t, 64).bfloat16(), f32(nw, t, 64).bfloat16()
        ws = [f32(64, 192, sc=0.1), f32(192, sc=0.1), f32(64, 64, sc=0.1), f32(64, sc=0.1),
              f32(4, t, t, sc=0.02)]
        mask = torch.from_numpy(shift_attn_mask(96, 96, side, side // 2)).to(dev)
        for name, m in (("unshifted", None), ("shifted", mask)):
            out[f"t{t} {name}"] = dict(
                bwd_ms=[ms(lambda: twa.window_attention_bwd(x, g, *ws, m, 4)) for _ in range(2)],
                fwd_ms=[ms(lambda: twa.window_attention(x, *ws, m, 4)) for _ in range(2)])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(label=args.label, root=str(root), card=card, bf16=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
