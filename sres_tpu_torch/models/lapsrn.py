"""LapSRN — Laplacian-pyramid SR (counterpart of sres_tpu/models/lapsrn.py;
reference sres/model/lapsrn/network.py).

Per ×2 level the features go through a k 2, stride 2 transposed conv and a
DoubleConv (``ConvUpStage``, the reference's "ConvDownscale", which
upsamples); the level below's result is upsampled by interpolation
(``ups_mode``, bicubic) and a 1×1 "crossscale" conv adds the residual. The
forward returns one f32 HR tensor a level, lowest first, for the pyramid
loss. Names: ``inc``, ``downscale.{i}.downscale.{0,1}``,
``crossscale.{i}.conv``.
"""
from __future__ import annotations

from typing import Mapping, Sequence, Tuple

import torch
import torch.nn as nn

from sres_tpu_torch.models.layers import Conv, ConvTranspose, DoubleConv
from sres_tpu_torch.models.registry import resolve_parms
from sres_tpu_torch.ops.resize import upsample


class ConvUpStage(nn.Module):
    def __init__(self, features: int, scale: int):
        super().__init__()
        self.downscale = nn.Sequential(ConvTranspose(features, features, 2, scale),
                                       DoubleConv(features, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.downscale(x)


class _CrossScale(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Pyramid(nn.Module):
    """The levels shared by LapSRN and MSCNN (lapsrn.py:44-49, mscnn.py
    :36-41): each adds the interpolated level below to its 1×1 residual."""

    def __init__(self, nfeatures: int, nchannels_out: int,
                 downscale_factors: Sequence[int], ups_mode: str):
        super().__init__()
        self.factors, self.ups_mode = list(downscale_factors), ups_mode
        self.downscale = nn.ModuleList([ConvUpStage(nfeatures, f) for f in self.factors])
        self.crossscale = nn.ModuleList([_CrossScale(nfeatures, nchannels_out)
                                         for _ in self.factors])

    def levels(self, x: torch.Tensor, features: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        results = [x.float()]
        for usf, stage, cross in zip(self.factors, self.downscale, self.crossscale):
            features = stage(features)
            xave = upsample(results[-1], float(usf), self.ups_mode)
            results.append(cross(features).float() + xave)
        return tuple(results[1:])


class LapSRN(Pyramid):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeatures: int,
                 downscale_factors: Sequence[int], ups_mode: str = "bicubic",
                 dtype: torch.dtype = torch.float32):
        super().__init__(nfeatures, nchannels_out, downscale_factors, ups_mode)
        self.dtype = dtype
        self.inc = DoubleConv(nchannels_in, nfeatures)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(B, Cin, h, w) LR → one f32 (B, Cout, ·, ·) tensor a level."""
        return self.levels(x, self.inc(x.to(self.dtype)))


def build(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
          dtype: torch.dtype = torch.float32) -> LapSRN:
    p = resolve_parms(model_cfg, {}, nchannels_in=nchannels_in, nchannels_out=nchannels_out)
    return LapSRN(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeatures=p["nfeatures"], downscale_factors=p["downscale_factors"],
        ups_mode=p["ups_mode"], dtype=dtype)
