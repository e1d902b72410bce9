"""UNet SR (counterpart of sres_tpu/models/unet.py; reference
sres/model/unet/network.py and common/unet.py): a DoubleConv stem → a UNet
encoder/decoder of depth ``nlayers`` → a transposed-conv ×2 upsampling
stage per downscale factor → a 1×1 output conv. With
``use_temporal_features`` the bottleneck's last DoubleConv gives
``ntemporal`` fewer channels and the (B, ntemporal) features of the batch's
timeslice are broadcast over the bottleneck's pixels and concatenated
there, as the JAX model does (unet.py:34-37; a dead path in the original
reference). Names: ``workflow.0`` (stem), ``workflow.1`` (the core:
``downscale.{i}.maxpool_conv.1``, ``upscale.{i}.{up,conv}``),
``workflow.2.ups{i}.{up,conv}``, ``workflow.3.conv``.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch
import torch.nn as nn

from sres_tpu_torch.models.layers import Conv, ConvTranspose, DoubleConv
from sres_tpu_torch.models.registry import resolve_parms


class _Up(nn.Module):
    """A transposed conv k 2, stride 2, its output concatenated with the
    skip (when given), then a DoubleConv."""

    def __init__(self, cin: int, cout: int, cskip: int = 0):
        super().__init__()
        self.up = ConvTranspose(cin, cout, 2, 2)
        self.conv = DoubleConv(cout + cskip, cout)

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.up(x)
        if skip is not None:
            x = torch.cat([x, skip], 1)
        return self.conv(x)


class _Down(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.maxpool_conv(x)


class UNetCore(nn.Module):
    """The shared UNet encoder/decoder (reference common/unet.py:7; JAX
    unet.py:13-41) on ``nfeatures`` channels in and out; ``ntemporal`` > 0
    reserves that many bottleneck channels for the time features."""

    def __init__(self, nfeatures: int, depth: int, ntemporal: int = 0):
        super().__init__()
        nf, self.depth, self.ntemporal = nfeatures, depth, ntemporal
        self.downscale = nn.ModuleList(
            [_Down(nf * 2 ** il, nf * 2 ** (il + 1) - (ntemporal if il == depth - 1 else 0))
             for il in range(depth)])
        self.upscale = nn.ModuleList(
            [_Up(nf * 2 ** (depth - il), nf * 2 ** (depth - il - 1), nf * 2 ** (depth - il - 1))
             for il in range(depth)])

    def forward(self, x: torch.Tensor, temporal: Optional[torch.Tensor] = None) -> torch.Tensor:
        skips = []
        for down in self.downscale:
            skips.insert(0, x)
            x = down(x)
        if self.ntemporal > 0:
            if temporal is None:
                raise ValueError(f"this UNet reserves {self.ntemporal} bottleneck channels "
                                 "for temporal features; pass the (B, ntemporal) features")
            b, _, h, w = x.shape
            t = temporal.to(device=x.device, dtype=x.dtype)[:, :, None, None]
            x = torch.cat([x, t.expand(b, t.shape[1], h, w)], 1)
        for up, skip in zip(self.upscale, skips):
            x = up(x, skip)
        return x


class _Ups(nn.Module):
    def __init__(self, nfeatures: int, nups: int):
        super().__init__()
        self.nups = nups
        for i in range(nups):
            setattr(self, f"ups{i}", _Up(nfeatures, nfeatures))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.nups):
            x = getattr(self, f"ups{i}")(x)
        return x


class _OutConv(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = Conv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class UNetSR(nn.Module):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeatures: int,
                 depth: int, downscale_factors: Sequence[int], ntemporal: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.ntemporal, nf = dtype, ntemporal, nfeatures
        self.workflow = nn.ModuleList([
            DoubleConv(nchannels_in, nf), UNetCore(nf, depth, ntemporal),
            _Ups(nf, len(list(downscale_factors))), _OutConv(nf, nchannels_out)])

    def forward(self, x: torch.Tensor, temporal: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, Cin, h, w) LR [+ (B, ntemporal) features] → (B, Cout, 4h, 4w)
        f32; h and w must divide by 2**nlayers."""
        stem, core, ups, out = self.workflow
        x = core(stem(x.to(self.dtype)), temporal)
        return out(ups(x)).float()


def build(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
          dtype: torch.dtype = torch.float32, temporal_features=None) -> UNetSR:
    """``temporal_features``: the dataset's (T, ntemporal) features, or
    their width; with ``use_temporal_features`` it sizes the bottleneck's
    reservation (the JAX build, unet.py:66-76)."""
    p = resolve_parms(model_cfg, dict(use_temporal_features=False),
                      nchannels_in=nchannels_in, nchannels_out=nchannels_out)
    ntemporal = 0
    if p.get("use_temporal_features") and temporal_features is not None:
        ntemporal = (int(temporal_features) if isinstance(temporal_features, int)
                     else int(temporal_features.shape[-1]))
    return UNetSR(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeatures=p["nfeatures"], depth=p["nlayers"],
        downscale_factors=p["downscale_factors"], ntemporal=ntemporal, dtype=dtype)
