"""EDSR — enhanced deep residual SR (counterpart of sres_tpu/models/edsr.py;
reference sres/model/edsr/network.py).

head conv → nlayers × ResBlock (conv → ReLU → conv, ×res_scale, + skip) →
body conv → global skip → pixel-shuffle upsampler → tail conv. Parameter
names are the reference's (``head.0``, ``body.{i}.body.{0,2}``,
``body.{nlayers}``, ``tail.0.{0,2}``, ``tail.1``), so
``sres_tpu.util.torch_export.export_edsr`` output loads with strict=True.

``winograd`` = 2|4 runs the trunk — every ResBlock, the body conv and the
global skip — through the Winograd kernels as one ungated group
(models/wino_blocks.py:WinoResTrunk) in channels_last memory; the
parameter set is the direct trunk's. Unlike the JAX model (edsr.py:54-66),
an unsupported trunk raises instead of falling back to the direct path: H
or W not a multiple of m raises ``ValueError`` here, and on the card a
width other than the kernels' 64 channels raises in the kernel wrappers.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

from sres_tpu_torch.models.layers import Conv, ResBlock, SPUpsample
from sres_tpu_torch.models.registry import resolve_parms
from sres_tpu_torch.models.wino_blocks import WinoResTrunk
from sres_tpu_torch.ops.int8_conv import check_mode
from sres_tpu_torch.ops.winograd import check_geometry


class EDSR(nn.Module):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeatures: int,
                 nlayers: int, kernel_size: int, scale: int,
                 res_scale: float = 1.0, use_bias: bool = True,
                 winograd: Optional[int] = None, lane_pack: int = 1,
                 quantization: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        quant = check_mode(quantization)
        self.quant, self.winograd = quant, None if quant else winograd
        if self.winograd and kernel_size != 3:
            raise ValueError("model.winograd needs kernel_size 3")
        self.dtype = dtype
        nf, k = nfeatures, kernel_size
        self.head = nn.Sequential(Conv(nchannels_in, nf, k, use_bias))
        if self.winograd:
            self.body = WinoResTrunk(nf, nlayers, winograd, res_scale, use_bias)
        else:
            self.body = nn.Sequential(
                *[ResBlock(nf, k, use_bias, res_scale, quant, lane_pack)
                  for _ in range(nlayers)],
                Conv(nf, nf, k, use_bias, quant=quant, pack=lane_pack))
        self.tail = nn.Sequential(SPUpsample(scale, nf),
                                  Conv(nf, nchannels_out, k, use_bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Cin, h, w) LR → (B, Cout, scale·h, scale·w) f32."""
        skip = self.head(x.to(self.dtype))
        if self.winograd:
            check_geometry(self.winograd, skip.shape[2], skip.shape[3])
            res = self.body(skip.contiguous(memory_format=torch.channels_last))
        else:
            if self.quant:
                skip = skip.contiguous(memory_format=torch.channels_last)
            res = self.body(skip) + skip
        return self.tail(res).float()


def build(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
          dtype: torch.dtype = torch.float32) -> EDSR:
    p = resolve_parms(model_cfg, dict(lane_pack=1, quantization=None,
                                      winograd=None, winograd_bs=0,
                                      scan_groups=False, remat_trunk=None),
                      nchannels_in=nchannels_in, nchannels_out=nchannels_out)
    # winograd_bs, scan_groups and remat_trunk are TPU layout and
    # compile-time levers: accepted, no effect here (ROADMAP "leaves out");
    # lane_pack sets the quantized convs' scale groups only
    return EDSR(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeatures=p["nfeatures"], nlayers=p["nlayers"],
        kernel_size=p["kernel_size"], scale=p["scale"],
        res_scale=float(p["res_scale"]), use_bias=p["bias"],
        winograd=(int(p["winograd"]) if p["winograd"] else None),
        lane_pack=int(p["lane_pack"]), quantization=p["quantization"], dtype=dtype)
