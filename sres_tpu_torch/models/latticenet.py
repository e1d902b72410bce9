"""LatticeNet (counterpart of sres_tpu/models/latticenet.py; reference
sres/model/latticenet/network.py): two stem convs → 4 lattice blocks
(butterfly pairs combined by mean + std channel attention) → reverse-fusion
1×1 compress stages → conv + pixel-shuffle tail. Names: ``conv1``,
``conv2``, ``body_unit{1..4}.{conv_block0, conv_block1}.{0,2,4}``,
``.{fea_ca1, x_ca1, fea_ca2, x_ca2}.{conv_mean, conv_std}.{0,2}``,
``.compress``, ``{T,L}_tdm{1,2,3}.0``, ``tail.{0,1}``.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from sres_tpu_torch.models.layers import Conv
from sres_tpu_torch.models.registry import resolve_parms


def _squeeze(channels: int, reduction: int) -> nn.Sequential:
    hidden = channels // reduction
    return nn.Sequential(Conv(channels, hidden, 1), nn.ReLU(),
                         Conv(hidden, channels, 1), nn.Sigmoid())


class CC(nn.Module):
    """Mean + std channel attention (latticenet.py:162-182): the gates of
    the per-channel mean and of the unbiased std (f32, ·n/(n−1)), averaged."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.conv_mean = _squeeze(channels, reduction)
        self.conv_std = _squeeze(channels, reduction)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        n = x.shape[2] * x.shape[3]
        mean = xf.mean((2, 3), keepdim=True)
        var = (xf - mean).square().mean((2, 3), keepdim=True) * (n / (n - 1))
        ca_mean = self.conv_mean(mean.to(x.dtype))
        ca_std = self.conv_std(torch.sqrt(var).to(x.dtype))
        return (ca_mean + ca_std) / 2.0


class _LeakyReLU(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.leaky_relu(x, 0.05)


def _conv_block3(nfeat: int, ndiff: int) -> nn.Sequential:
    """Three 3×3 convs with leaky ReLU 0.05 (latticenet.py:185-196)."""
    mods, cin = [], nfeat
    for feats in (nfeat - ndiff, nfeat - ndiff, nfeat):
        mods += [Conv(cin, feats, 3), _LeakyReLU()]
        cin = feats
    return nn.Sequential(*mods)


class LatticeBlock(nn.Module):
    def __init__(self, nfeat: int, ndiff: int):
        super().__init__()
        self.conv_block0 = _conv_block3(nfeat, ndiff)
        self.fea_ca1 = CC(nfeat)
        self.x_ca1 = CC(nfeat)
        self.conv_block1 = _conv_block3(nfeat, ndiff)
        self.fea_ca2 = CC(nfeat)
        self.x_ca2 = CC(nfeat)
        self.compress = Conv(2 * nfeat, nfeat, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = self.conv_block0(x)
        p1z = x + self.fea_ca1(xs) * xs
        q1z = xs + self.x_ca1(x) * x
        xl = self.conv_block1(p1z)
        p3z = xl + self.fea_ca2(q1z) * q1z
        q3z = q1z + self.x_ca2(xl) * xl
        return self.compress(torch.cat([p3z, q3z], 1))


def _tdm(cin: int, nfeat: int) -> nn.Sequential:
    return nn.Sequential(Conv(cin, nfeat // 2, 1), nn.ReLU())


class LatticeNet(nn.Module):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeatures: int,
                 ndiff: int, kernel_size: int, scale: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, nf = dtype, nfeatures
        self.conv1 = Conv(nchannels_in, nf, kernel_size)
        self.conv2 = Conv(nf, nf, kernel_size)
        for b in range(1, 5):
            setattr(self, f"body_unit{b}", LatticeBlock(nf, ndiff))
        for i in range(1, 4):
            setattr(self, f"T_tdm{i}", _tdm(nf, nf))
            setattr(self, f"L_tdm{i}", _tdm(nf, nf))
        self.tail = nn.Sequential(Conv(nf, nf, 3), Conv(nf, nchannels_out * scale ** 2, 3),
                                  nn.PixelShuffle(scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Cin, h, w) LR → (B, Cout, scale·h, scale·w) f32."""
        x = self.conv2(self.conv1(x.to(self.dtype)))
        res1 = self.body_unit1(x)
        res2 = self.body_unit2(res1)
        res3 = self.body_unit3(res2)
        res4 = self.body_unit4(res3)
        out = torch.cat([self.T_tdm1(res4), self.L_tdm1(res3)], 1)
        out = torch.cat([self.T_tdm2(out), self.L_tdm2(res2)], 1)
        out = torch.cat([self.T_tdm3(out), self.L_tdm3(res1)], 1)
        return self.tail(out + x).float()


def build(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
          dtype: torch.dtype = torch.float32) -> LatticeNet:
    p = resolve_parms(model_cfg, dict(ndiff=16),
                      nchannels_in=nchannels_in, nchannels_out=nchannels_out)
    return LatticeNet(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeatures=p["nfeatures"], ndiff=p["ndiff"], kernel_size=p["kernel_size"],
        scale=p["scale"], dtype=dtype)
