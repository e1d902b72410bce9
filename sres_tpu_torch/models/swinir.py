"""SwinIR-style windowed-attention SR (counterpart of sres_tpu/models/
swinir.py; BASELINE config #4, config/model/swinir.yaml).

head conv → nlayers × (nblocks × SwinBlock, alternately shifted by
window/2, then a conv, plus the group skip) → body conv → global skip →
pixel-shuffle upsampler → tail conv. Parameter names are the public
SwinIR's (JingyunLiang/SwinIR ``models/network_swinir.py``): ``conv_first``,
``layers.{g}.residual_group.blocks.{b}.{norm1, attn.qkv, attn.proj,
attn.relative_position_bias_table, norm2, mlp.fc1, mlp.fc2}``,
``layers.{g}.conv``, ``conv_after_body``, ``upsample.{0,2}``,
``conv_last``; ``util.weights.export_swinir`` maps the JAX trees onto them.

Layout: NCHW at the model's boundary; inside a group the tokens are (B, H,
W, C) and the convs get the same memory as channels_last NCHW views, so
the permutes between them copy nothing. Every window-attention call runs
``WindowAttentionFn`` (the CUDA kernels on the card, their twins on the
CPU or with ``plain = True``); ``model.fused_attention`` picks between two
JAX modules that compute the same function, and is accepted with no
effect here. The convs, LayerNorms, the MLP and GELU stay plain torch, as
they are XLA ops in JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from sres_tpu_torch.models.layers import Conv, LayerNorm, Linear, SPUpsample
from sres_tpu_torch.models.registry import resolve_parms
from sres_tpu_torch.ops.window_attention import WindowAttentionFn


# ------------------------------------------ helpers (swinir.py:30-66)
def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nw, ws², C), windows in (b, i, j) order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).transpose(2, 3)
    return x.reshape(-1, ws * ws, c)


def window_merge(win: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B·nw, ws², C) → (B, H, W, C)."""
    c = win.shape[-1]
    b = win.shape[0] // ((h // ws) * (w // ws))
    x = win.reshape(b, h // ws, w // ws, ws, ws, c).transpose(2, 3)
    return x.reshape(b, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws², ws²) indices into the (2ws-1)² bias table (standard swin)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nw, ws², ws²) additive mask (0 / -100) for shifted windows."""
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    win = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = win[:, :, None] - win[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------- modules
class WindowAttention(nn.Module):
    """Windowed multi-head attention with a learned relative-position bias
    (the JAX ``FusedWindowAttention`` / ``WindowAttention``, swinir.py:69-131)."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1)), persistent=False)
        self.plain = False

    @torch.no_grad()
    def init_seeded(self, gen: torch.Generator) -> None:
        """The table from flax's truncated_normal(0.02): cut at ±2σ."""
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02,
                              a=-0.04, b=0.04, generator=gen)

    def forward(self, win: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(NW, T, C) tokens in the compute dtype; ``mask`` the (nm, T, T)
        group mask or None."""
        t = self.window_size ** 2
        bias = self.relative_position_bias_table[self.relative_position_index]
        bias = bias.reshape(t, t, self.num_heads).permute(2, 0, 1).float()
        return WindowAttentionFn.apply(
            win, self.qkv.weight.t(), self.qkv.bias, self.proj.weight.t(),
            self.proj.bias, bias, mask, self.num_heads, self.plain)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1, self.fc2 = Linear(dim, hidden), Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # flax nn.gelu is the tanh approximation
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SwinBlock(nn.Module):
    """LN → (shifted) window attention → skip; LN → MLP → skip, on (B, H,
    W, C) tokens (swinir.py:134-167)."""

    def __init__(self, dim: int, window_size: int, num_heads: int, shift: int,
                 mlp_ratio: float):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self._masks: Dict[Tuple, torch.Tensor] = {}

    def _mask(self, h: int, w: int, dev: torch.device) -> torch.Tensor:
        """The (nm, T, T) group mask of an h×w tile, cached; a normal tensor
        even when first built under ``inference_mode``, so that a model
        served and then trained can save it for backward."""
        key = (h, w, dev)
        if key not in self._masks:
            with torch.inference_mode(False):
                self._masks[key] = torch.from_numpy(
                    shift_attn_mask(h, w, self.window_size, self.shift)).to(dev)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = x.shape
        ws, sh = self.window_size, self.shift
        y = self.norm1(x)
        mask = None
        if sh > 0:
            y = torch.roll(y, (-sh, -sh), (1, 2))
            mask = self._mask(h, w, x.device)
        y = window_merge(self.attn(window_partition(y, ws), mask), ws, h, w)
        if sh > 0:
            y = torch.roll(y, (sh, sh), (1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class RSTB(nn.Module):
    """One residual Swin group without its skip: the blocks on the tokens,
    then the conv (the group skip is the caller's)."""

    def __init__(self, dim: int, nblocks: int, window_size: int, num_heads: int,
                 mlp_ratio: float):
        super().__init__()
        self.residual_group = BasicLayer([
            SwinBlock(dim, window_size, num_heads,
                      window_size // 2 if b % 2 == 1 else 0, mlp_ratio)
            for b in range(nblocks)])
        self.conv = Conv(dim, dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW in channels_last memory, so its (B, H, W, C) permute is
        contiguous."""
        t = self.residual_group(x.permute(0, 2, 3, 1))
        return self.conv(t.permute(0, 3, 1, 2))


class SwinIR(nn.Module):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeatures: int,
                 nlayers: int, nblocks: int, window_size: int, num_heads: int,
                 mlp_ratio: float, scale: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size, self.dtype = window_size, dtype
        nf = nfeatures
        # every conv is 3×3, whatever model.kernel_size says (swinir.py:188)
        self.conv_first = Conv(nchannels_in, nf, 3)
        self.layers = nn.ModuleList([
            RSTB(nf, nblocks, window_size, num_heads, mlp_ratio)
            for _ in range(nlayers)])
        self.conv_after_body = Conv(nf, nf, 3)
        self.upsample = SPUpsample(scale, nf)
        self.conv_last = Conv(nf, nchannels_out, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Cin, h, w) LR → (B, Cout, scale·h, scale·w) f32."""
        ws = self.window_size
        if x.shape[2] % ws or x.shape[3] % ws:
            raise ValueError(f"tile {tuple(x.shape[2:])} not divisible by "
                             f"window {ws}")
        x = self.conv_first(x.to(self.dtype))
        x = x.contiguous(memory_format=torch.channels_last)
        res = x
        for layer in self.layers:
            res = res + layer(res)
        res = self.conv_after_body(res) + x
        return self.conv_last(self.upsample(res)).float()


def build(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
          dtype: torch.dtype = torch.float32) -> SwinIR:
    p = resolve_parms(model_cfg, dict(window_size=8, num_heads=4, mlp_ratio=2.0,
                                      nblocks=2, fused_attention=False),
                      nchannels_in=nchannels_in, nchannels_out=nchannels_out)
    return SwinIR(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeatures=p["nfeatures"], nlayers=p["nlayers"], nblocks=p["nblocks"],
        window_size=p["window_size"], num_heads=p["num_heads"],
        mlp_ratio=float(p["mlp_ratio"]), scale=p["scale"], dtype=dtype)
