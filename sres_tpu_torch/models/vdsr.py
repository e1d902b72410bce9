"""VDSR — very deep SR (counterpart of sres_tpu/models/vdsr.py; reference
sres/model/vdsr/network.py): nearest-upsample the LR input to the HR grid,
a stack of ``nlayers`` conv blocks (ReLU but the last), and the global
skip. Parameter names are the reference's, ``body.{i}.0`` (``body.{i}.1``
the BatchNorm with ``batch_norm: true``), as ``export_vdsr`` emits them.
``model.quantization`` (the JAX model's AQT int8 stack) raises.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn

from sres_tpu_torch.models.layers import BasicBlock, nearest_up
from sres_tpu_torch.models.registry import resolve_parms


class VDSR(nn.Module):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeatures: int,
                 nlayers: int, kernel_size: int, scale: int, use_bias: bool = True,
                 batch_norm: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale, self.dtype = scale, dtype
        k, nf = kernel_size, nfeatures
        blocks = [BasicBlock(nchannels_in, nf, k, use_bias, batch_norm)]
        blocks += [BasicBlock(nf, nf, k, use_bias, batch_norm) for _ in range(nlayers - 2)]
        blocks.append(BasicBlock(nf, nchannels_out, k, use_bias, batch_norm, relu=False))
        self.body = nn.Sequential(*blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Cin, h, w) LR → (B, Cout, scale·h, scale·w) f32."""
        x = nearest_up(x.to(self.dtype), self.scale)
        return (x + self.body(x)).float()


def build(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
          dtype: torch.dtype = torch.float32) -> VDSR:
    p = resolve_parms(model_cfg, dict(quantization=None),
                      nchannels_in=nchannels_in, nchannels_out=nchannels_out)
    if p["quantization"]:
        raise NotImplementedError(
            f"model.quantization={p['quantization']!r} is not ported: "
            "ROADMAP Queue 1 item 10")
    return VDSR(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeatures=p["nfeatures"], nlayers=p["nlayers"], kernel_size=p["kernel_size"],
        scale=p["scale"], use_bias=p["bias"], batch_norm=p["batch_norm"], dtype=dtype)
