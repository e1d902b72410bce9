"""Building blocks in PyTorch (counterparts of sres_tpu/models/layers.py
:193-223 Conv, :226-246 ConvTranspose, :249-270 PReLU and Scale, :273-346
BatchNorm, :352-445 CALayer/RCAB/ResidualGroup, :448-473 ResBlock, :476-494
BasicBlock, :497-530 SPUpsample, :532-586 UpsampleStage/BNResidual/
DoubleConv, :589-600 the pools and nearest upsampling; and flax's Dense and
LayerNorm as SwinIR and ESRT use them).

Module and parameter names follow the reference torch networks
(sres/model/rcan/network.py, edsr/network.py, common/{cnn,residual,
upsample,unet}.py) — the naming that ``sres_tpu.util.torch_export`` emits —
so an exported JAX state dict loads with ``strict=True``.

Precision: parameters are f32; every module computes in its input's dtype,
casting its weights at use (the JAX modules' ``dtype=``). These convs are
plain ``F.conv2d`` and ``F.conv_transpose2d`` (cuDNN on the card), as they
are XLA convs in JAX, unless a ``Conv`` is built with ``quant`` (one of
``ops.int8_conv.MODES``: the ``quant_conv_fn`` hook of layers.py:104-117,
reached from ``Conv`` and ``_PackedConvCore``): it then runs on the s8
kernels of ``ops/int8_conv.py``, its activation scales shared over groups
of ``pack`` consecutive samples when the batch holds that many (JAX's lane
packing: a pack of tiles shares one scale).

BatchNorm is torch-exact and padding-aware, as the JAX ``_TorchBNCore``:
statistics in f32, normalisation by the biased batch variance, the running
variance updated with the unbiased one at torch's momentum. The trainer
pads ragged batches with zero-weight tiles; the mechanism that keeps them
out of train-mode statistics is a context manager owned by this module,
``bn_sample_weight(w)``: the steps scope the batch's (B,) weight vector
around the forward, and every ``BatchNorm`` in training mode reads the
innermost scope (sres_tpu's ``bn_sample_weight``, layers.py:30-53).
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from sres_tpu_torch.ops.int8_conv import check_mode, quant_conv

class Conv(nn.Conv2d):
    """k×k conv, torch-default init; by default stride 1 and 'same' zero
    padding k//2 (reference default_conv: sres/model/common/cnn.py:8), or
    an explicit stride and padding (DBPN's down-projection, k 8, s 4, p 2
    at ×4: sres_tpu/models/dbpn.py:28-32). With ``quant`` (stride 1, 'same'
    only) it is a quantized conv (``ops.int8_conv.quant_conv``): ``pack``
    consecutive samples share an activation scale when the batch holds
    that many, else each has its own (sres_tpu/models/rcan.py:76); ``plain``
    then routes it through the kernels' twins."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 bias: bool = True, stride: int = 1,
                 padding: Optional[int] = None, quant: Optional[str] = None,
                 pack: int = 1):
        super().__init__(cin, cout, kernel_size, stride=stride,
                         padding=kernel_size // 2 if padding is None else padding,
                         bias=bias)
        self.quant = check_mode(quant)
        if self.quant:
            if stride != 1 or self.padding != (kernel_size // 2,) * 2 or kernel_size % 2 == 0:
                raise ValueError("a quantized conv is stride-1 'same' with an odd kernel")
            self.pack, self.plain = max(1, int(pack)), False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant:
            pk = self.pack if x.shape[0] >= self.pack else 1
            return quant_conv(x, self.weight, self.bias, self.quant, pk, self.plain)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv2d(x, self.weight.to(x.dtype), b, stride=self.stride,
                        padding=self.padding)


class ConvTranspose(nn.ConvTranspose2d):
    """torch ``ConvTranspose2d(k, stride=s, padding=p)``: out = (in-1)·s +
    k - 2p (DBPN's up-projections, UNet's and LapSRN's upsamplers). The
    seeded init draws U(±1/sqrt(cin·k²)), the JAX module's fan-in
    (layers.py:241)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, stride: int,
                 padding: int = 0, bias: bool = True):
        super().__init__(cin, cout, kernel_size, stride=stride, padding=padding,
                         bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv_transpose2d(x, self.weight.to(x.dtype), b, stride=self.stride,
                                  padding=self.padding)


class PReLU(nn.PReLU):
    """torch PReLU, one slope (``channels`` = 1) or one a channel, starting
    at ``init``; computes in the input's dtype."""

    def __init__(self, channels: int = 1, init: float = 0.25):
        super().__init__(channels, init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.prelu(x, self.weight.to(x.dtype))


class Scale(nn.Module):
    """A learnable scalar multiplier (reference ESRT ``blocks.Scale``)."""

    def __init__(self, init: float = 1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.full((1,), float(init)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


_BN_SAMPLE_WEIGHT: List[Optional[torch.Tensor]] = [None]


class bn_sample_weight:
    """Scopes a (B,) 0/1 sample-weight vector over a forward, so that
    train-mode ``BatchNorm`` statistics skip the zero-weight (padding)
    samples. ``None`` scopes no weights (plain batch statistics)."""

    def __init__(self, w: Optional[torch.Tensor]):
        self.w = w

    def __enter__(self):
        _BN_SAMPLE_WEIGHT.append(self.w)

    def __exit__(self, *exc):
        _BN_SAMPLE_WEIGHT.pop()


class BatchNorm(nn.BatchNorm2d):
    """Torch-exact, padding-aware BatchNorm2d (sres_tpu/models/layers.py
    :273-331 ``_TorchBNCore``). Training mode: mean and biased variance of
    the f32 input over (B, H, W), counting only the samples of weight 1
    when a ``bn_sample_weight`` scope is active; the running statistics
    move by torch's ``momentum`` (0.1; SRDN's 0.5), the variance's by its
    unbiased value var·n/(n-1); a batch of no weight leaves them as they
    were and gives finite output. With every weight 1 the output is
    ``F.batch_norm``'s in training mode, within f32 rounding. Eval mode
    normalises by the running statistics. The output is in the input's
    dtype; ``num_batches_tracked`` counts the batches that moved them."""

    def __init__(self, features: int, momentum: float = 0.1):
        super().__init__(features, eps=1e-5, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # statistics in f32 (in f64 for an f64 input, a reference's)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        c = lambda v: v.reshape(1, -1, 1, 1)
        if not self.training:
            mean, var = self.running_mean, self.running_var
            d = xf - c(mean)
        else:
            w = _BN_SAMPLE_WEIGHT[-1]
            m = float(self.momentum)
            if w is None:
                mean = xf.mean((0, 2, 3))
                d = xf - c(mean)
                var = d.square().mean((0, 2, 3))
                n = x.numel() // x.shape[1]
                bessel, mk = n / max(n - 1, 1), m
            else:
                # zero-weight samples add exact zeros to both sums; n counts
                # the real elements only
                wf = w.to(device=x.device, dtype=xf.dtype).reshape(-1, 1, 1, 1)
                n = wf.sum() * (x.shape[2] * x.shape[3])
                nsafe = n.clamp_min(1.0)
                mean = (xf * wf).sum((0, 2, 3)) / nsafe
                d = xf - c(mean)
                var = (d.square() * wf).sum((0, 2, 3)) / nsafe
                bessel = nsafe / (nsafe - 1.0).clamp_min(1.0)
                mk = m * (n > 0).float()
            with torch.no_grad():
                self.running_mean.copy_((1.0 - mk) * self.running_mean + mk * mean)
                self.running_var.copy_((1.0 - mk) * self.running_var + mk * var * bessel)
                self.num_batches_tracked.add_(1 if w is None else (n > 0).long())
        y = d * c(torch.rsqrt(var + self.eps))
        return (y * c(self.weight) + c(self.bias)).to(x.dtype)


def has_batch_norm(model: nn.Module) -> bool:
    """Whether ``model`` holds a BatchNorm (its steps then scope the sample
    weights and carry running statistics)."""
    return any(isinstance(m, nn.modules.batchnorm._BatchNorm) for m in model.modules())


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
    :392-395); ``quant`` reaches its two 3×3 convs, the CA's 1×1 convs stay
    in full precision (:381-405)."""

    def __init__(self, features: int, kernel_size: int, reduction: int,
                 quant: Optional[str] = None, pack: int = 1):
        super().__init__()
        self.body = nn.Sequential(Conv(features, features, kernel_size, quant=quant, pack=pack),
                                  nn.ReLU(),
                                  Conv(features, features, kernel_size, quant=quant, pack=pack),
                                  CALayer(features, reduction))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class ResidualGroup(nn.Module):
    """nblocks × RCAB + trailing conv + group skip (reference
    rcan/network.py:67); the trailing conv always has a bias
    (sres_tpu/models/layers.py:433); ``quant`` reaches every RCAB and the
    trailing conv (:443-444)."""

    def __init__(self, features: int, kernel_size: int, reduction: int,
                 nblocks: int, quant: Optional[str] = None, pack: int = 1):
        super().__init__()
        blocks = [RCAB(features, kernel_size, reduction, quant, pack) for _ in range(nblocks)]
        self.body = nn.Sequential(*blocks, Conv(features, features, kernel_size,
                                                quant=quant, pack=pack))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x)


class ResBlock(nn.Module):
    """conv → ReLU → conv residual block scaled by ``res_scale`` (reference
    common/residual.py:28): x + res_scale·body(x); ``quant`` reaches both
    convs."""

    def __init__(self, features: int, kernel_size: int = 3, bias: bool = True,
                 res_scale: float = 1.0, quant: Optional[str] = None, pack: int = 1):
        super().__init__()
        self.res_scale = res_scale
        self.body = nn.Sequential(
            Conv(features, features, kernel_size, bias, quant=quant, pack=pack),
            nn.ReLU(),
            Conv(features, features, kernel_size, bias, quant=quant, pack=pack))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.body(x) * self.res_scale


class BasicBlock(nn.Sequential):
    """conv [→ BatchNorm] [→ ReLU] (reference common/cnn.py:11): indices 0
    (conv, quantized with ``quant``), 1 (BatchNorm, when present)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 bias: bool = False, batch_norm: bool = True, relu: bool = True,
                 quant: Optional[str] = None):
        mods = [Conv(cin, cout, kernel_size, bias, quant=quant)]
        if batch_norm:
            mods.append(BatchNorm(cout))
        if relu:
            mods.append(nn.ReLU())
        super().__init__(*mods)


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


class NearestUp(nn.Module):
    """Nearest-neighbour ×``scale`` upsampling: each pixel repeated
    scale × scale times (layers.py:597-600)."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nearest_up(x, self.scale)


def nearest_up(x: torch.Tensor, scale: int) -> torch.Tensor:
    b, c, h, w = x.shape
    y = x[:, :, :, None, :, None].expand(b, c, h, scale, w, scale)
    return y.reshape(b, c, h * scale, w * scale)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, 2)


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2)


class UpsampleStage(nn.Module):
    """SRDN's upscaler (reference common/upsample.py:5): ``usnet`` = conv,
    nearest ×scale, PReLU (slope 0) for ``replicate``, or a transposed conv
    (k, stride scale, padding 0), an empty slot and the PReLU for
    ``transpose``, so the PReLU is ``usnet.2`` either way."""

    def __init__(self, cin: int, features: int, scale: int,
                 method: str = "replicate", kernel_size: int = 3):
        super().__init__()
        if method == "replicate":
            up = [Conv(cin, features, kernel_size), NearestUp(scale)]
        elif method == "transpose":
            up = [ConvTranspose(cin, features, kernel_size, scale), nn.Identity()]
        else:
            raise ValueError(f"Unknown upsample method {method}")
        self.usnet = nn.Sequential(*up, PReLU(1, init=0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.usnet(x)


class BNResidual(nn.Module):
    """conv → BN → PReLU (slope 0) → conv → BN, plus the skip (reference
    common/residual.py:5, SRDN; BN momentum 0.5): ``rnet.{0..4}``."""

    def __init__(self, features: int, kernel_size: int = 3, momentum: float = 0.5):
        super().__init__()
        self.rnet = nn.Sequential(
            Conv(features, features, kernel_size), BatchNorm(features, momentum),
            PReLU(1, init=0.0), Conv(features, features, kernel_size),
            BatchNorm(features, momentum))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.rnet(x)


class DoubleConv(nn.Module):
    """(conv without bias → BN → ReLU) × 2 (reference common/unet.py:7):
    ``double_conv.{0, 1, 3, 4}``."""

    def __init__(self, cin: int, features: int, mid: Optional[int] = None):
        super().__init__()
        mid = mid or features
        self.double_conv = nn.Sequential(
            Conv(cin, mid, 3, bias=False), BatchNorm(mid), nn.ReLU(),
            Conv(mid, features, 3, bias=False), BatchNorm(features), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.double_conv(x)


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
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


@torch.no_grad()
def init_torch_default(model: nn.Module, seed: int) -> nn.Module:
    """Re-draw every conv's, transposed conv's and linear layer's weight
    and bias from U(±1/sqrt(fan_in)) — torch's Conv2d and Linear default
    (kaiming_uniform a=√5); a transposed conv's fan-in is cin·k², as the
    JAX module's — with one seeded generator, in module order; a module
    with an ``init_seeded(gen)`` method draws its own parameters from the
    same generator at its place in that order. LayerNorm and BatchNorm
    keep ones and zeros (and BatchNorm its running statistics), PReLU its
    ``init`` slope and Scale its 1."""
    gen = torch.Generator().manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, nn.ConvTranspose2d):
            bound = 1.0 / math.sqrt(mod.weight[:, 0].numel())
            mod.weight.uniform_(-bound, bound, generator=gen)
            if mod.bias is not None:
                mod.bias.uniform_(-bound, bound, generator=gen)
        elif isinstance(mod, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(mod.weight[0].numel())
            mod.weight.uniform_(-bound, bound, generator=gen)
            if mod.bias is not None:
                mod.bias.uniform_(-bound, bound, generator=gen)
        elif hasattr(mod, "init_seeded"):
            mod.init_seeded(gen)
    return model


def set_plain_twins(model: nn.Module, plain: bool) -> nn.Module:
    """Route every kernel-backed module of ``model`` (those with a ``plain``
    flag: the Winograd trunk, window attention, the quantized convs)
    through the plain twins (True) or the kernels (False)."""
    for mod in model.modules():
        if hasattr(mod, "plain"):
            mod.plain = plain
    return model
