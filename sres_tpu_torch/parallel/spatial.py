"""Whole-region inference (counterpart of sres_tpu/parallel/spatial.py:64-105).

JAX shards the region's H axis over its device mesh and lets GSPMD place
the conv halo exchanges. One process of the port drives one card, so
``infer_region_sharded`` is one forward of the whole active region as a
single image (B = 1); on the Winograd trunks every conv and channel
attention of that forward is one kernel launch over the whole region.
``halo_conv2d`` and sharding a region over cards wait for multi-GPU
(ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import torch


def infer_region_sharded(model: torch.nn.Module, region: torch.Tensor) -> torch.Tensor:
    """(B, Cin, h, w) LR region on the model's device → (B, Cout, scale·h,
    scale·w) f32, the model in eval mode under ``torch.inference_mode``."""
    model.eval()
    with torch.inference_mode():
        return model(region)
