"""Building blocks in PyTorch (counterparts of sres_tpu/models/layers.py
:193-223 Conv, :352-445 CALayer/RCAB/ResidualGroup, :448-473 ResBlock,
:497-530 SPUpsample; and flax's Dense and LayerNorm as SwinIR uses them).

Module and parameter names follow the reference torch networks
(sres/model/rcan/network.py, edsr/network.py, common/residual.py,
common/upsample.py) — the naming that ``sres_tpu.util.torch_export``'s
``export_rcan`` and ``export_edsr`` emit — so an exported JAX state dict
loads with ``strict=True``.

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
    body = conv → ReLU → conv → CA, then the block skip. Its convs always
    have a bias, whatever ``model.bias`` says (sres_tpu/models/layers.py
    :392-395)."""

    def __init__(self, features: int, kernel_size: int, reduction: int):
        super().__init__()
        self.body = nn.Sequential(Conv(features, features, kernel_size),
                                  nn.ReLU(),
                                  Conv(features, features, kernel_size),
                                  CALayer(features, reduction))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class ResidualGroup(nn.Module):
    """nblocks × RCAB + trailing conv + group skip (reference
    rcan/network.py:67); the trailing conv always has a bias
    (sres_tpu/models/layers.py:433)."""

    def __init__(self, features: int, kernel_size: int, reduction: int,
                 nblocks: int):
        super().__init__()
        blocks = [RCAB(features, kernel_size, reduction) for _ in range(nblocks)]
        self.body = nn.Sequential(*blocks, Conv(features, features, kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class ResBlock(nn.Module):
    """conv → ReLU → conv residual block scaled by ``res_scale`` (reference
    common/residual.py:28): x + res_scale·body(x)."""

    def __init__(self, features: int, kernel_size: int = 3, bias: bool = True,
                 res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.body = nn.Sequential(Conv(features, features, kernel_size, bias),
                                  nn.ReLU(),
                                  Conv(features, features, kernel_size, bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x) * self.res_scale


class SPUpsample(nn.Sequential):
    """Sub-pixel upsampler: per ×2 (or ×3) stage a conv to r²·C channels and
    a pixel shuffle (reference common/upsample.py:32). Indices 0, 2 hold the
    convs for ×4. Its convs always have a bias: every JAX model builds its
    ``SPUpsample`` with the default ``use_bias=True``."""

    def __init__(self, scale: int, features: int):
        stages = []
        if scale & (scale - 1) == 0:
            for _ in range(int(math.log2(scale))):
                stages += [Conv(features, 4 * features, 3), nn.PixelShuffle(2)]
        elif scale == 3:
            stages += [Conv(features, 9 * features, 3), nn.PixelShuffle(3)]
        else:
            raise NotImplementedError(f"SPUpsample scale {scale}")
        super().__init__(*stages)


class Linear(nn.Linear):
    """Dense layer computing in its input's dtype (the flax ``nn.Dense``
    with ``dtype=``); torch-default init."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm``: ε = 1e-6, statistics and affine in f32, the
    result in the input's dtype."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


@torch.no_grad()
def init_torch_default(model: nn.Module, seed: int) -> nn.Module:
    """Re-draw every conv's and linear layer's weight and bias from
    U(±1/sqrt(fan_in)) — torch's Conv2d and Linear default (kaiming_uniform
    a=√5) — with one seeded generator, in module order; a module with an
    ``init_seeded(gen)`` method draws its own parameters from the same
    generator at its place in that order. LayerNorm keeps ones and zeros."""
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            mod.weight.uniform_(-bound, bound, generator=gen)
            if mod.bias is not None:
                mod.bias.uniform_(-bound, bound, generator=gen)
        elif hasattr(mod, "init_seeded"):
            mod.init_seeded(gen)
    return model


def set_plain_twins(model: nn.Module, plain: bool) -> nn.Module:
    """Route every kernel-backed module of ``model`` (those with a ``plain``
    flag: the Winograd trunk, window attention) through the plain twins
    (True) or the kernels (False)."""
    for mod in model.modules():
        if hasattr(mod, "plain"):
            mod.plain = plain
    return model
