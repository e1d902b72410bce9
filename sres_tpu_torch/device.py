"""Device and precision resolution.

``resolve_device``: ``cuda`` (or ``cuda:N``) when asked, and an error when
asked for and absent; ``cpu`` only when asked. There is no silent fallback
from the card to the CPU.

``compute_dtype``: ``pipeline.precision`` → the activation dtype. Parameters
stay f32; modules cast them to the activation dtype at use, as the JAX
models' ``dtype=`` does (sres_tpu/models/registry.py:45-47).
"""
from __future__ import annotations

import torch

_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
           "f32": torch.float32, "float32": torch.float32}


def resolve_device(name: str) -> torch.device:
    """'cuda' / 'cuda:N' / 'cpu' → torch.device; raises when CUDA is asked
    for and not available, and on anything else (including 'auto')."""
    try:
        dev = torch.device(name)
    except RuntimeError:
        dev = None
    if dev is not None and dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but "
                               "torch.cuda.is_available() is False")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {name!r} requested but only "
                               f"{torch.cuda.device_count()} CUDA devices exist")
        return dev
    if dev is not None and dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r}: use 'cuda[:N]' or 'cpu'")


def compute_dtype(precision: str) -> torch.dtype:
    """pipeline.precision ('bf16' | 'f32' and long forms) → torch dtype."""
    try:
        return _DTYPES[precision]
    except KeyError:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"use one of {sorted(_DTYPES)}") from None
