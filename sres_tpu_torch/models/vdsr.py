"""VDSR — very deep SR (counterpart of sres_tpu/models/vdsr.py; reference
sres/model/vdsr/network.py): nearest-upsample the LR input to the HR grid,
a stack of ``nlayers`` conv blocks (ReLU but the last), and the global
skip. Parameter names are the reference's, ``body.{i}.0`` (``body.{i}.1``
the BatchNorm with ``batch_norm: true``), as ``export_vdsr`` emits them.
``quantization`` (ops/int8_conv.py) quantizes the conv of every block but
the last (vdsr.py:28-35), the first at cin = ``nchannels_in`` on the HR
grid; each sample has its own activation scale (VDSR packs no tiles).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

from sres_tpu_torch.models.layers import BasicBlock, nearest_up
from sres_tpu_torch.models.registry import resolve_parms
from sres_tpu_torch.ops.int8_conv import check_mode


class VDSR(nn.Module):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeatures: int,
                 nlayers: int, kernel_size: int, scale: int, use_bias: bool = True,
                 batch_norm: bool = False, quantization: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.scale, self.dtype = scale, dtype
        k, nf, q = kernel_size, nfeatures, check_mode(quantization)
        blocks = [BasicBlock(nchannels_in, nf, k, use_bias, batch_norm, quant=q)]
        blocks += [BasicBlock(nf, nf, k, use_bias, batch_norm, quant=q)
                   for _ in range(nlayers - 2)]
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
    return VDSR(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeatures=p["nfeatures"], nlayers=p["nlayers"], kernel_size=p["kernel_size"],
        scale=p["scale"], use_bias=p["bias"], batch_norm=p["batch_norm"],
        quantization=p["quantization"], dtype=dtype)
