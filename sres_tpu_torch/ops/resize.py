"""Separable resize with exact torch ``F.interpolate`` semantics, as two f32
matmuls per image (counterpart of sres_tpu/ops/resize.py:45-140).

The LR input of every eval request is the bicubic ×4 downsample of the HR
tile, and the model is scored against the bicubic ×4 upsample of that LR
input. Each spatial axis is resampled by a dense (out, in) weight matrix
built once on the host; ``resize_matrix`` is the JAX module's numpy code,
copied because that module imports ``jax.numpy`` at the top. Layout is NCHW
(any leading dims; the last two are H, W).
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

_CUBIC_A = -0.75  # torch / OpenCV bicubic coefficient


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    """W(x) for the Keys cubic convolution kernel with a = -0.75."""
    ax = np.abs(x)
    a = _CUBIC_A
    return np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * (ax**3 - 5.0 * ax**2 + 8.0 * ax - 4.0), 0.0),
    )


@lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, mode: str = "bicubic",
                  scale: Optional[float] = None,
                  align_corners: bool = False) -> np.ndarray:
    """(out_size, in_size) float32 resampling matrix matching torch semantics.

    ``scale`` is the torch ``scale_factor`` (out/in); when provided, source
    coordinates use it directly (torch's recompute_scale_factor=False path),
    otherwise out_size/in_size is used.
    """
    s = (out_size / in_size) if scale is None else float(scale)
    dst = np.arange(out_size, dtype=np.float64)
    if mode == "nearest":
        src_idx = np.clip(np.floor(dst / s).astype(np.int64), 0, in_size - 1)
        m = np.zeros((out_size, in_size), dtype=np.float64)
        m[np.arange(out_size), src_idx] = 1.0
        return m.astype(np.float32)
    if align_corners:
        ac = (np.float32((in_size - 1) / (out_size - 1)) if out_size > 1
              else np.float32(0))
        src = (dst.astype(np.float32) * ac).astype(np.float32)
    else:
        # half-pixel centres, evaluated in f32 as torch's CPU kernel does
        rs = np.float32(1.0 / s)
        src = ((dst.astype(np.float32) + np.float32(0.5)) * rs
               - np.float32(0.5)).astype(np.float32)
    m = np.zeros((out_size, in_size), dtype=np.float64)
    if mode in ("bilinear", "linear"):
        i0 = np.floor(src).astype(np.int64)
        frac = (src - i0.astype(np.float32)).astype(np.float32)
        for tap, w in ((i0, np.float32(1.0) - frac), (i0 + 1, frac)):
            np.add.at(m, (np.arange(out_size), np.clip(tap, 0, in_size - 1)), w)
    elif mode in ("bicubic", "cubic"):
        i0 = np.floor(src).astype(np.int64)
        frac = (src - i0.astype(np.float32)).astype(np.float32)
        for k in range(-1, 3):
            w = _cubic_kernel((frac - np.float32(k)).astype(np.float32)
                              ).astype(np.float32)
            np.add.at(m, (np.arange(out_size), np.clip(i0 + k, 0, in_size - 1)), w)
    else:
        raise ValueError(f"Unknown resize mode: {mode}")
    return m.astype(np.float32)


def interp_mode(cfg_mode: str) -> str:
    """Task-config mode names ('cubic'/'linear') → ours."""
    return {"linear": "bilinear", "cubic": "bicubic"}.get(cfg_mode, cfg_mode)


def _out_size(in_size: int, scale: float) -> int:
    return int(math.floor(in_size * scale))


def resize(x: torch.Tensor, out_hw: Tuple[int, int], mode: str = "bicubic",
           scale: Optional[float] = None) -> torch.Tensor:
    """Resize (..., H, W) ``x`` to ``out_hw``; computed and returned in f32."""
    h_in, w_in = x.shape[-2], x.shape[-1]
    mh = torch.from_numpy(resize_matrix(h_in, out_hw[0], mode, scale)).to(x.device)
    mw = torch.from_numpy(resize_matrix(w_in, out_hw[1], mode, scale)).to(x.device)
    return torch.matmul(torch.matmul(mh, x.float()), mw.T)


def downsample(x: torch.Tensor, scale_factor: float,
               mode: str = "bicubic") -> torch.Tensor:
    """LR synthesis: shrink by ``scale_factor`` (> 1), matching
    ``F.interpolate(scale_factor=1/scale_factor)`` and its floor size rule."""
    s = 1.0 / scale_factor
    out_hw = (_out_size(x.shape[-2], s), _out_size(x.shape[-1], s))
    return resize(x, out_hw, mode, scale=s)


def upsample(x: torch.Tensor, scale_factor: float,
             mode: str = "bicubic") -> torch.Tensor:
    """Interpolation baseline: grow by ``scale_factor``."""
    out_hw = (_out_size(x.shape[-2], scale_factor),
              _out_size(x.shape[-1], scale_factor))
    return resize(x, out_hw, mode, scale=float(scale_factor))
