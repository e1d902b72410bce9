"""A/B timing of the Winograd conv kernel of two checkouts on one card.

    python sres_tpu_torch/probes/wino_ab.py [--root DIR] [--label NAME]

Imports ``sres_tpu_torch`` from DIR (the root of a checkout; by default the
one holding this file; run the file by its path, so that no other copy of
the package is imported first), builds its kernels there, and times the
bf16 ``sres_wino_conv`` entry at the flagship shape (72, 64, 48, 48) in the
modes the Winograd trunks call it in: ``relu`` (a block's first conv, m=4),
``bias`` (a block's second conv in RCAN, m=4), ``scaled`` (EDSR's ResBlock
skip, res + 0.1·conv, m=4), ``residual`` (the trailing conv and the group
skip, m=4) and ``relu`` at m=2. U is handed over already in the checkout's
kernel order (``winograd_conv._operand``, or ``_kernel_u`` in checkouts
that reordered it on every call), so the reading is the kernel's alone.
Device time: a ``torch.cuda._sleep`` holds the stream while the host
queues 20 calls, then CUDA events time them; two readings each, after 3
warm-up calls. Operands come from a fixed numpy seed, so two checkouts
time the same inputs. Prints one JSON line with the card's name and power
limit.

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
    from sres_tpu_torch.ops import winograd_conv as twc
    from sres_tpu_torch.ops.winograd import transform_weights
    lib = cuda.load()
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

    rng = np.random.default_rng(12)
    f32 = lambda *s, sc=1.0: torch.from_numpy(
        (rng.normal(size=s) * sc).astype(np.float32)).to(dev)
    x, r = (f32(*SHAPE).bfloat16().contiguous(memory_format=cl) for _ in range(2))
    w, b = f32(64, 64, 3, 3, sc=0.04), f32(64, sc=0.04)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream

    def kernel_order(m):
        u = transform_weights(w, m).to(torch.bfloat16)
        if hasattr(twc, "_operand"):
            return twc._operand(u, m, x, 64)
        return twc._kernel_u(u, m, x, 64)

    def call(u, m, relu, res, scale):
        def run():
            err = lib.sres_wino_conv(x.data_ptr(), u.data_ptr(), b.data_ptr(),
                                     None if res is None else res.data_ptr(), y.data_ptr(),
                                     SHAPE[0], SHAPE[2], SHAPE[3], m, 1, int(relu),
                                     float(scale), 0, stream)
            if err:
                raise RuntimeError(f"sres_wino_conv: CUDA error {err}")
        return run

    u4, u2 = kernel_order(4), kernel_order(2)
    modes = {"relu": call(u4, 4, True, None, 1.0), "bias": call(u4, 4, False, None, 1.0),
             "scaled": call(u4, 4, False, r, 0.1), "residual": call(u4, 4, False, r, 1.0),
             "m2 relu": call(u2, 2, True, None, 1.0)}
    out = {k: [ms(f) for _ in range(2)] for k, f in modes.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(label=args.label, root=str(root), card=card, shape=SHAPE,
                          bf16_device_ms=out)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
