"""Design choices of the fused trunk's channel-attention stream, measured.

    python -m sres_tpu_torch.probes.ca_variants

Builds ``probes/ca_variants.cu`` (a stand-alone program on
``ops/cuda/ca_common.cuh``) with nvcc into ``_build/probe_ca/`` and runs it:
device times, in microseconds at (72, 64, 48, 48) bf16, of the stream
x + c·gate with its gates computed beforehand, loading through L1
(``ldg``) or past it (``noalloc``, as shipped); launched cooperatively with
a grid barrier (``coop``) and with each sample's gate computed before it
(``gates``, the shipped scheme); with x and c staged through shared memory
by bulk copies (``ring``) or by a per-thread cp.async pipeline
(``cpasync``); and the stream with no gate (``copy``). Needs a CUDA card
and nvcc; prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from sres_tpu_torch.ops import cuda


def main() -> int:
    src = Path(__file__).with_name("ca_variants.cu")
    out = cuda.BUILD_DIR / "probe_ca"
    out.mkdir(parents=True, exist_ok=True)
    exe = out / "ca_variants"
    build = subprocess.run([cuda.nvcc_path(), *cuda.ARCH_FLAGS, "-std=c++17", "-O3", "-o",
                            str(exe), str(src)], capture_output=True, text=True)
    if build.returncode != 0:
        raise SystemExit(f"nvcc failed on {src.name}:\n{build.stdout}{build.stderr}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    run = subprocess.run([str(exe)], capture_output=True, text=True)
    print(card)
    print(run.stdout.strip())
    return run.returncode


if __name__ == "__main__":
    sys.exit(main())
