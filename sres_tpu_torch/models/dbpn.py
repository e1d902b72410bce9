"""DBPN — deep back-projection network (counterpart of sres_tpu/models/
dbpn.py; reference sres/model/dbpn/network.py).

Two stem convs with PReLU, then alternating up- and down-projection units
(``DenseProjection``) on dense concatenations of all earlier units'
outputs, and a 3×3 reconstruction conv over every up-projection. The
projection convs take the scale's (kernel, stride, padding) from
``CONV_SPEC`` (reference dbpn/blocks.py:4); an up-projection is a
transposed conv, a down-projection a strided conv. Names:
``initial.{0..3}``, ``upmodules.{i}``, ``downmodules.{i}`` (each
``[bottleneck.{0,1}], conv_{1,2,3}.{0,1}``), ``reconstruction.0``.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn

from sres_tpu_torch.models.layers import Conv, ConvTranspose, PReLU
from sres_tpu_torch.models.registry import resolve_parms

CONV_SPEC = {2: (6, 2, 2), 4: (8, 4, 2), 8: (12, 8, 2)}


def _proj(cin: int, cout: int, scale: int, up: bool) -> nn.Sequential:
    k, s, p = CONV_SPEC[scale]
    conv = (ConvTranspose(cin, cout, k, s, p) if up
            else Conv(cin, cout, k, stride=s, padding=p))
    return nn.Sequential(conv, PReLU(cout))


class DenseProjection(nn.Module):
    """Project ``x`` up (or down), back, and the residual again: a0 + a1
    (dbpn.py:86-104). With ``bottleneck`` a 1×1 conv + PReLU first brings
    the concatenated input to ``features`` channels."""

    def __init__(self, cin: int, features: int, scale: int, up: bool, bottleneck: bool):
        super().__init__()
        if bottleneck:
            self.bottleneck = nn.Sequential(Conv(cin, features, 1), PReLU(features))
            cin = features
        else:
            self.bottleneck = None
        self.conv_1 = _proj(cin, features, scale, up)
        self.conv_2 = _proj(features, cin, scale, not up)
        self.conv_3 = _proj(cin, features, scale, up)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bottleneck is not None:
            x = self.bottleneck(x)
        a0 = self.conv_1(x)
        e = self.conv_2(a0) - x
        return a0 + self.conv_3(e)


class DBPN(nn.Module):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeatures: int,
                 nprojection: int, depth: int, scale: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.depth = dtype, depth
        npf = nprojection
        self.initial = nn.Sequential(Conv(nchannels_in, nfeatures, 3), PReLU(nfeatures),
                                     Conv(nfeatures, npf, 1), PReLU(npf))
        # the i-th up unit reads the concatenation of the i down units before
        # it (x alone at i = 0), the i-th down unit that of the i+1 up units
        self.upmodules = nn.ModuleList(
            [DenseProjection(npf * max(i, 1), npf, scale, True, i > 1) for i in range(depth)])
        self.downmodules = nn.ModuleList(
            [DenseProjection(npf * (i + 1), npf, scale, False, i != 0)
             for i in range(depth - 1)])
        self.reconstruction = nn.Sequential(Conv(npf * depth, nchannels_out, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Cin, h, w) LR → (B, Cout, scale·h, scale·w) f32."""
        x = self.initial(x.to(self.dtype))
        h_list, l_list = [], []
        for i in range(self.depth - 1):
            inp = x if i == 0 else torch.cat(l_list, 1)
            h_list.append(self.upmodules[i](inp))
            l_list.append(self.downmodules[i](torch.cat(h_list, 1)))
        h_list.append(self.upmodules[self.depth - 1](torch.cat(l_list, 1)))
        return self.reconstruction(torch.cat(h_list, 1)).float()


def build(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
          dtype: torch.dtype = torch.float32) -> DBPN:
    p = resolve_parms(model_cfg, dict(nprojectionfeatures=32, depth=2),
                      nchannels_in=nchannels_in, nchannels_out=nchannels_out)
    return DBPN(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeatures=p["nfeatures"], nprojection=p["nprojectionfeatures"],
        depth=p["depth"], scale=p["scale"], dtype=dtype)
