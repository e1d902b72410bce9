"""RCAN — residual channel-attention network (counterpart of
sres_tpu/models/rcan.py; reference sres/model/rcan/network.py).

head conv → nlayers × ResidualGroup(nblocks × RCAB) → body conv → global
skip → pixel-shuffle upsampler → tail conv. Parameter names are the
reference's (``head.0``, ``body.{g}.body.{b}.body.{0,2}``,
``body.{g}.body.{b}.body.3.conv_du.{0,2}``, ``body.{g}.body.{nb}``,
``body.{nl}``, ``tail.0.{0,2}``, ``tail.1``), so
``sres_tpu.util.torch_export.export_rcan`` output loads with strict=True.

``winograd`` = 2|4 runs the trunk — every residual group and the body conv —
through the Winograd kernels (models/wino_blocks.py) in channels_last
memory; the parameter set is the same as the direct path's. Unlike the JAX
model, an unsupported geometry (H or W not a multiple of m) raises instead
of falling back to the direct path.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

from sres_tpu_torch.models.layers import Conv, ResidualGroup, SPUpsample
from sres_tpu_torch.models.registry import resolve_parms
from sres_tpu_torch.models.wino_blocks import WinoConv, WinoResidualGroup
from sres_tpu_torch.ops.winograd import check_geometry


class RCAN(nn.Module):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeatures: int,
                 nlayers: int, nblocks: int, cbottleneck: int, kernel_size: int,
                 scale: int, use_bias: bool = True,
                 winograd: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if winograd and kernel_size != 3:
            raise ValueError("model.winograd needs kernel_size 3")
        self.winograd = winograd
        self.dtype = dtype
        nf, k = nfeatures, kernel_size
        self.head = nn.Sequential(Conv(nchannels_in, nf, k, use_bias))
        if winograd:
            groups = [WinoResidualGroup(nf, cbottleneck, nblocks, winograd,
                                        use_bias) for _ in range(nlayers)]
            body_conv = WinoConv(nf, nf, winograd, use_bias)
        else:
            groups = [ResidualGroup(nf, k, cbottleneck, nblocks, use_bias)
                      for _ in range(nlayers)]
            body_conv = Conv(nf, nf, k, use_bias)
        self.body = nn.Sequential(*groups, body_conv)
        self.tail = nn.Sequential(SPUpsample(scale, nf, use_bias),
                                  Conv(nf, nchannels_out, k, use_bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Cin, h, w) LR → (B, Cout, scale·h, scale·w) f32."""
        skip = self.head(x.to(self.dtype))
        if self.winograd:
            check_geometry(self.winograd, skip.shape[2], skip.shape[3])
            skip = skip.contiguous(memory_format=torch.channels_last)
            res = skip
            for group in list(self.body)[:-1]:
                res = group(res)
            res = self.body[-1](res, residual=skip)
        else:
            res = self.body(skip) + skip
        return self.tail(res).float()


def build(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
          dtype: torch.dtype = torch.float32) -> RCAN:
    p = resolve_parms(model_cfg, dict(cbottleneck=2, nblocks=20, fused=False,
                                      pervar_heads=False, lane_pack=1,
                                      quantization=None, remat_trunk=None,
                                      winograd=None, winograd_bs=0,
                                      scan_groups=False),
                      nchannels_in=nchannels_in, nchannels_out=nchannels_out)
    # lane_pack, winograd_bs, scan_groups and remat_trunk are TPU layout and
    # compile-time levers: accepted, no effect here (ROADMAP "leaves out")
    if p["fused"]:
        raise NotImplementedError(
            "model.fused (the attic residual-group kernel) is not ported: "
            "ROADMAP Queue 2 items 9 and 10")
    if p["quantization"]:
        raise NotImplementedError(
            f"model.quantization={p['quantization']!r} is not ported: "
            "ROADMAP Queue 1 item 10")
    if p["pervar_heads"]:
        raise NotImplementedError(
            "model.pervar_heads is not ported: ROADMAP Queue 1 item 3")
    return RCAN(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeatures=p["nfeatures"], nlayers=p["nlayers"], nblocks=p["nblocks"],
        cbottleneck=p["cbottleneck"], kernel_size=p["kernel_size"],
        scale=p["scale"], use_bias=p["bias"],
        winograd=(int(p["winograd"]) if p["winograd"] else None), dtype=dtype)
