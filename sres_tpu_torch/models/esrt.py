"""ESRT — hybrid CNN + efficient-transformer SR (counterpart of
sres_tpu/models/esrt.py; reference sres/model/esrt/network.py and
common/{transformer,tools}.py).

Each ``Un`` block runs three ``Updownblock`` high/low-frequency encoders
and a multi-head attention (``MLABlock``) over 3×3-unfolded patch tokens.
``EffAttention`` splits the token sequence into 4 quarters that attend
only within themselves (block-diagonal attention; SURVEY.md §5.7), as one
batched ``torch.matmul`` and an f32 softmax — plain PyTorch, as the JAX
model's are einsum and softmax outside any Pallas kernel. The unfold and
fold are torch's (``F.unfold``/``F.fold``, feature order c·9 + dy·3 + dx).
Names follow the reference (``util.weights.export_esrt``); every
``OneModule`` holds the reference's unused ``weight1`` Scale, so that an
exported tree loads with strict=True.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from sres_tpu_torch.models.layers import (CALayer, Conv, LayerNorm, Linear, PReLU, Scale,
                                          SPUpsample, avg_pool2)
from sres_tpu_torch.models.registry import resolve_parms
from sres_tpu_torch.ops.resize import resize


def extract_patches_3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W, C·9) tokens, 'same' zero padding; feature
    order c·9 + dy·3 + dx (torch Unfold)."""
    return F.unfold(x, 3, padding=1).transpose(1, 2)


def fold_patches_3x3(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H·W, C·9) → (B, C, H, W): the overlap-add of the 3×3 taps (torch
    Fold, padding 1, stride 1)."""
    return F.fold(tokens.transpose(1, 2), (h, w), 3, padding=1)


class _BasicConv(nn.Module):
    """The reference's ``BasicConv`` as ESRT uses it: a conv without bias,
    then ReLU (``relu`` False: none)."""

    def __init__(self, cin: int, cout: int, kernel_size: int, relu: bool = True):
        super().__init__()
        self.conv = Conv(cin, cout, kernel_size, bias=False)
        self.relu = relu

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return F.relu(y) if self.relu else y


class OneConv(nn.Module):
    def __init__(self, features: int, growth: int):
        super().__init__()
        self.conv = Conv(features, growth, 3)
        self.relu = PReLU(growth)
        self.conv1 = Conv(growth, features, 3)
        self.weight1, self.weight2 = Scale(1.0), Scale(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weight1(x) + self.weight2(self.conv1(self.relu(self.conv(x))))


class OneModule(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        nf = features
        self.layer1 = OneConv(nf, nf // 2)
        self.layer2 = OneConv(nf, nf // 2)
        self.weight1 = Scale(1.0)        # unused in the reference's forward
        self.weight2, self.weight3 = Scale(1.0), Scale(1.0)
        self.alise = _BasicConv(2 * nf, nf, 1)
        self.atten = CALayer(nf, 16)
        self.layer4 = _BasicConv(nf, nf, 3)
        self.weight4, self.weight5 = Scale(1.0), Scale(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.layer1(x)
        x2 = self.layer2(x1)
        y = self.alise(torch.cat([self.weight2(x2), self.weight3(x1)], 1))
        y = self.layer4(self.atten(y))
        return self.weight4(x) + self.weight5(y)


def _resize_ac(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear, align_corners=True, computed in f32, back in x's dtype."""
    return resize(x, hw, "bilinear", align_corners=True).to(x.dtype)


class Updownblock(nn.Module):
    """High/low-frequency split: the low band (2×2 average pool) through
    one shared ``decoder_low`` applied 5 times (esrt.py:355-379)."""

    def __init__(self, features: int):
        super().__init__()
        nf = features
        self.encoder = OneModule(nf)
        self.decoder_low = OneModule(nf)
        self.decoder_high = OneModule(nf)
        self.alise = OneModule(nf)
        self.alise2 = _BasicConv(2 * nf, nf, 1)
        self.att = CALayer(nf, 16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = (x.shape[2], x.shape[3])
        x1 = self.encoder(x)
        x2 = avg_pool2(x1)
        high = x1 - _resize_ac(x2, hw)
        low = x2
        for _ in range(5):
            low = self.decoder_low(low)
        high1 = self.decoder_high(high)
        y = self.alise2(torch.cat([_resize_ac(low, hw), high1], 1))
        return self.alise(self.att(y)) + x


class EffAttention(nn.Module):
    """Block-local efficient attention (reference common/transformer.py:76;
    esrt.py:382-411): ``reduce`` to dim/2, ``qkv``, 8 heads, the tokens in
    4 quarters that attend within themselves, softmax in f32, ``proj``."""

    def __init__(self, dim: int, num_heads: int = 8, nsplits: int = 4):
        super().__init__()
        self.num_heads, self.nsplits = num_heads, nsplits
        half = dim // 2
        self.scale = (dim // num_heads) ** -0.5
        self.reduce = Linear(dim, half, bias=False)
        self.qkv = Linear(half, half * 3, bias=False)
        self.proj = Linear(half, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        x = self.reduce(x)
        half, h, s = x.shape[-1], self.num_heads, self.nsplits
        if n % s:
            raise ValueError(f"token count {n} not divisible by {s}")
        hd = half // h
        # (3, b, heads, splits, n/splits, hd)
        qkv = self.qkv(x).reshape(b, n, 3, h, hd).permute(2, 0, 3, 1, 4)
        q, k, v = (t.reshape(b, h, s, n // s, hd) for t in qkv)
        attn = torch.matmul(q, k.transpose(-1, -2)) * self.scale
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        out = torch.matmul(attn, v).reshape(b, h, n, hd).transpose(1, 2)
        return self.proj(out.reshape(b, n, half))


class _MLP(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = Linear(dim, dim // 4)
        self.fc2 = Linear(dim // 4, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(x)))


class MLABlock(nn.Module):
    """Patch-token transformer block (reference common/transformer.py:131)."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.atten = EffAttention(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = _MLP(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = extract_patches_3x3(x)
        tokens = tokens + self.atten(self.norm1(tokens))
        return tokens + self.mlp(self.norm2(tokens))


class Un(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        nf = features
        self.encoder1 = Updownblock(nf)
        self.encoder2 = Updownblock(nf)
        self.encoder3 = Updownblock(nf)
        self.reduce = Conv(3 * nf, nf, 3)
        self.attention = MLABlock(nf * 9)
        self.alise = Conv(nf, nf, 3)
        self.weight1, self.weight2 = Scale(1.0), Scale(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.encoder1(x)
        x2 = self.encoder2(x1)
        x3 = self.encoder3(x2)
        h, w = x3.shape[2], x3.shape[3]
        out = self.attention(self.reduce(torch.cat([x1, x2, x3], 1)))
        out = self.alise(fold_patches_3x3(out, h, w))
        return self.weight1(x) + self.weight2(out)


class ESRT(nn.Module):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeatures: int,
                 nlayers: int, kernel_size: int, scale: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, nf, k = dtype, nfeatures, kernel_size
        self.head = nn.Sequential(Conv(nchannels_in, nf, k, use_bias))
        self.body = nn.ModuleList([Un(nf) for _ in range(nlayers)])
        self.reduce = Conv(nlayers * nf, nf, k, use_bias)
        self.tail = nn.Sequential(SPUpsample(scale, nf), Conv(nf, nchannels_out, k, use_bias))
        self.up = nn.Sequential(SPUpsample(scale, nf), _BasicConv(nf, nchannels_out, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Cin, h, w) LR → (B, Cout, scale·h, scale·w) f32; h·w must
        divide by 4 (the attention's quarters)."""
        x1 = self.head(x.to(self.dtype))
        res1 = self.reduce(torch.cat([un(x1) for un in self.body], 1))
        return (self.up(x1) + self.tail(res1)).float()


def build(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
          dtype: torch.dtype = torch.float32) -> ESRT:
    p = resolve_parms(model_cfg, {}, nchannels_in=nchannels_in, nchannels_out=nchannels_out)
    return ESRT(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeatures=p["nfeatures"], nlayers=p["nlayers"], kernel_size=p["kernel_size"],
        scale=p["scale"], use_bias=p["bias"], dtype=dtype)
