"""MSCNN — multiscale CNN (counterpart of sres_tpu/models/mscnn.py;
reference sres/model/mscnn/network.py): LapSRN's pyramid with a UNet
feature stage first, of depth ``nlayers`` (as the JAX model takes it,
mscnn.py:45). Names: LapSRN's, and ``unet.{downscale,upscale}...``.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import torch

from sres_tpu_torch.models.lapsrn import Pyramid
from sres_tpu_torch.models.layers import DoubleConv
from sres_tpu_torch.models.registry import resolve_parms
from sres_tpu_torch.models.unet import UNetCore


class MSCNN(Pyramid):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeatures: int,
                 unet_depth: int, downscale_factors: Sequence[int],
                 ups_mode: str = "bicubic", dtype: torch.dtype = torch.float32):
        super().__init__(nfeatures, nchannels_out, downscale_factors, ups_mode)
        self.dtype = dtype
        self.inc = DoubleConv(nchannels_in, nfeatures)
        self.unet = UNetCore(nfeatures, unet_depth) if unet_depth > 0 else None

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(B, Cin, h, w) LR → one f32 (B, Cout, ·, ·) tensor a level."""
        features = self.inc(x.to(self.dtype))
        if self.unet is not None:
            features = self.unet(features)
        return self.levels(x, features)


def build(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
          dtype: torch.dtype = torch.float32) -> MSCNN:
    p = resolve_parms(model_cfg, {}, nchannels_in=nchannels_in, nchannels_out=nchannels_out)
    return MSCNN(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeatures=p["nfeatures"], unet_depth=p["nlayers"],
        downscale_factors=p["downscale_factors"], ups_mode=p["ups_mode"], dtype=dtype)
