"""SRDN (counterpart of sres_tpu/models/srdn.py; reference
sres/model/srdn/network.py): conv + PReLU stem → ``nlayers`` BN residual
blocks → conv + BN global residual → one upsampling stage per downscale
factor (``usmethod`` ``replicate``: conv + nearest; ``transpose``: a
transposed conv) → a wide output conv. ``nfeatures`` and ``kernel_size``
are dicts by role ({hidden, upscale} and {features, hidden, output}); the
BatchNorms run at momentum 0.5. Names: ``features.{0,1}``,
``residuals.Residual-{i}.rnet.{0..4}``, ``global_residual.{0,1}``,
``upscaling.{i}.usnet.{0,2}``, ``result``.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Mapping, Sequence

import torch
import torch.nn as nn

from sres_tpu_torch.models.layers import BatchNorm, BNResidual, Conv, PReLU, UpsampleStage
from sres_tpu_torch.models.registry import resolve_parms


class SRDN(nn.Module):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeat_hidden: int,
                 nfeat_upscale: int, nlayers: int, k_features: int, k_hidden: int,
                 k_output: int, downscale_factors: Sequence[int],
                 usmethod: str = "replicate", momentum: float = 0.5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, nh = dtype, nfeat_hidden
        self.features = nn.Sequential(Conv(nchannels_in, nh, k_features), PReLU(1, init=0.0))
        self.residuals = nn.Sequential(OrderedDict(
            (f"Residual-{i}", BNResidual(nh, k_hidden, momentum)) for i in range(nlayers)))
        self.global_residual = nn.Sequential(Conv(nh, nh, k_hidden), BatchNorm(nh, momentum))
        ups, cin = [], nh
        for sf in downscale_factors:
            ups.append(UpsampleStage(cin, nfeat_upscale, sf, usmethod, k_hidden))
            cin = nfeat_upscale
        self.upscaling = nn.Sequential(*ups)
        self.result = Conv(cin, nchannels_out, k_output)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Cin, h, w) LR → (B, Cout, scale·h, scale·w) f32."""
        f = self.features(x.to(self.dtype))
        y = f + self.global_residual(self.residuals(f))
        return self.result(self.upscaling(y)).float()


def build(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
          dtype: torch.dtype = torch.float32) -> SRDN:
    p = resolve_parms(model_cfg, dict(usmethod="replicate", momentum=0.5),
                      nchannels_in=nchannels_in, nchannels_out=nchannels_out)
    nf, ks = dict(p["nfeatures"]), dict(p["kernel_size"])
    return SRDN(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeat_hidden=nf["hidden"], nfeat_upscale=nf["upscale"], nlayers=p["nlayers"],
        k_features=ks["features"], k_hidden=ks["hidden"], k_output=ks["output"],
        downscale_factors=p["downscale_factors"], usmethod=p["usmethod"],
        momentum=float(p["momentum"]), dtype=dtype)
