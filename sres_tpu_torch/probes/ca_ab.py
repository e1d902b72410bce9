"""A/B timing of the channel-attention kernels of two checkouts on one card.

    python sres_tpu_torch/probes/ca_ab.py [--root DIR] [--label NAME]

Imports ``sres_tpu_torch`` from DIR (the root of a checkout; by default the
one holding this file; run the file by its path, so that no other copy of
the package is imported first), builds its kernels there, and times, in
device time, the Winograd trunk's ``ca_skip`` (q + r·gate(r)) at the
flagship shape (72, 64, 48, 48) in bf16 and f32 and at (2, 64, 192, 192)
in bf16, and the fused trunk's ``fgroup_ca`` (x + c·gate from the conv's
per-tile sums, c in f32) at (72, 64, 48, 48) in bf16, serving and with the
stash of c; and the backwards: ``ca_skip_bwd`` (da f32, c2 bf16) at (72,
64, 48, 48) and (2, 64, 192, 192), ``fgroup_ca_bwd`` (g and c bf16) at
(72, 64, 48, 48). All are called through their Python wrappers, whose
signatures every checkout shares; a ``torch.cuda._sleep`` holds the stream
while the host queues 20 calls, then CUDA events time them: two readings
each, after 3 warm-up calls. Operands come from a fixed numpy seed, so two
checkouts time the same inputs. Prints one JSON line with the card's name
and power limit and each mode's bound (its bytes over 3.35 TB/s).

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

SHAPE, LARGE = (72, 64, 48, 48), (2, 64, 192, 192)
SLEEP_CYCLES = 50_000_000      # about 27 ms: longer than queueing 20 calls
HBM_BYTES_S = 3.35e12


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
    from sres_tpu_torch.ops import fused_group as fg
    from sres_tpu_torch.ops import winograd_conv as twc
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

    rng = np.random.default_rng(13)
    f32 = lambda *s, sc=1.0, dc=0.0: torch.from_numpy(
        (rng.normal(size=s) * sc + dc).astype(np.float32)).to(dev)
    ca = [f32(32, 64, sc=0.1), f32(32, sc=0.1), f32(64, 32, sc=0.1), f32(64, sc=0.1)]
    q, r = f32(*SHAPE).contiguous(memory_format=cl), f32(*SHAPE, dc=0.3).contiguous(memory_format=cl)
    qb, rb = q.bfloat16(), r.bfloat16()
    ql, rl = (f32(*LARGE, dc=0.3).bfloat16().contiguous(memory_format=cl) for _ in range(2))
    part = f32(SHAPE[0], 18, 64, sc=40.0)
    gate = f32(SHAPE[0], 64).sigmoid()
    dal = f32(*LARGE).contiguous(memory_format=cl)
    n = q.numel()
    modes = {"ca_skip bf16": (lambda: twc.ca_skip(qb, rb, *ca), 3 * 2 * n),
             "ca_skip f32": (lambda: twc.ca_skip(q, r, *ca), 3 * 4 * n),
             "ca_skip bf16 192x192": (lambda: twc.ca_skip(ql, rl, *ca), 3 * 2 * ql.numel()),
             "fgroup_ca bf16": (lambda: fg.fgroup_ca(qb, r, part, *ca), (2 + 4 + 2) * n),
             "fgroup_ca bf16 stash": (lambda: fg.fgroup_ca(qb, r, part, *ca, stash_c=True),
                                      (2 + 4 + 2 + 2) * n),
             "ca_skip_bwd bf16": (lambda: twc.ca_skip_bwd(q, rb, *ca), (4 + 2) * n),
             "ca_skip_bwd bf16 192x192": (lambda: twc.ca_skip_bwd(dal, rl, *ca),
                                          (4 + 2) * ql.numel()),
             "fgroup_ca_bwd bf16": (lambda: fg.fgroup_ca_bwd(qb, rb, gate, *ca), (2 + 2) * n)}
    out = {k: [ms(f) for _ in range(2)] for k, (f, _) in modes.items()}
    bound = {k: 1e3 * b / HBM_BYTES_S for k, (_, b) in modes.items()}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(label=args.label, root=str(root), card=card, device_ms=out,
                          bound_ms=bound)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
