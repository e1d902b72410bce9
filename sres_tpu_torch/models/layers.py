"""RCAN building blocks in PyTorch (counterparts of sres_tpu/models/layers.py
:193-223 Conv, :352-445 CALayer/RCAB/ResidualGroup, :497-530 SPUpsample).

Module and parameter names follow the reference torch networks
(sres/model/rcan/network.py, common/upsample.py) — the naming that
``sres_tpu.util.torch_export.export_rcan`` emits — so an exported JAX
state dict loads with ``strict=True``.

Precision: parameters are f32; every module computes in its input's dtype,
casting its weights at use (the JAX modules' ``dtype=``). These convs are
plain ``F.conv2d`` (cuDNN on the card), as they are XLA convs in JAX.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv(nn.Conv2d):
    """k×k conv, stride 1, 'same' zero padding k//2, torch-default init
    (reference default_conv: sres/model/common/cnn.py:8)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 bias: bool = True):
        super().__init__(cin, cout, kernel_size, padding=kernel_size // 2,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv2d(x, self.weight.to(x.dtype), b, padding=self.padding)


class CALayer(nn.Module):
    """Squeeze-excite channel attention (reference rcan/network.py:31):
    global mean → 1×1 bottleneck → ReLU → 1×1 → sigmoid gate."""

    def __init__(self, channels: int, reduction: int):
        super().__init__()
        hidden = channels // reduction
        self.conv_du = nn.Sequential(Conv(channels, hidden, 1), nn.ReLU(),
                                     Conv(hidden, channels, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float().mean((2, 3), keepdim=True).to(x.dtype)
        return x * self.conv_du(y)


class RCAB(nn.Module):
    """Residual channel-attention block (reference rcan/network.py:50):
    body = conv → ReLU → conv → CA, then the block skip."""

    def __init__(self, features: int, kernel_size: int, reduction: int,
                 bias: bool = True):
        super().__init__()
        self.body = nn.Sequential(Conv(features, features, kernel_size, bias),
                                  nn.ReLU(),
                                  Conv(features, features, kernel_size, bias),
                                  CALayer(features, reduction))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class ResidualGroup(nn.Module):
    """nblocks × RCAB + trailing conv + group skip (reference
    rcan/network.py:67)."""

    def __init__(self, features: int, kernel_size: int, reduction: int,
                 nblocks: int, bias: bool = True):
        super().__init__()
        blocks = [RCAB(features, kernel_size, reduction, bias)
                  for _ in range(nblocks)]
        self.body = nn.Sequential(*blocks,
                                  Conv(features, features, kernel_size, bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class SPUpsample(nn.Sequential):
    """Sub-pixel upsampler: per ×2 (or ×3) stage a conv to r²·C channels and
    a pixel shuffle (reference common/upsample.py:32). Indices 0, 2 hold the
    convs for ×4."""

    def __init__(self, scale: int, features: int, bias: bool = True):
        stages = []
        if scale & (scale - 1) == 0:
            for _ in range(int(math.log2(scale))):
                stages += [Conv(features, 4 * features, 3, bias), nn.PixelShuffle(2)]
        elif scale == 3:
            stages += [Conv(features, 9 * features, 3, bias), nn.PixelShuffle(3)]
        else:
            raise NotImplementedError(f"SPUpsample scale {scale}")
        super().__init__(*stages)


@torch.no_grad()
def init_torch_default(model: nn.Module, seed: int) -> nn.Module:
    """Re-draw every conv's weight and bias from U(±1/sqrt(fan_in)) — torch's
    Conv2d default (kaiming_uniform a=√5) — with one seeded generator, in
    module order."""
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            bound = 1.0 / math.sqrt(mod.in_channels * mod.kernel_size[0]
                                    * mod.kernel_size[1])
            mod.weight.uniform_(-bound, bound, generator=gen)
            if mod.bias is not None:
                mod.bias.uniform_(-bound, bound, generator=gen)
    return model
