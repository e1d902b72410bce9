"""Winograd F(m×m, 3×3) math: transform constants, geometry checks, the
weight transform and a plain einsum reference (counterpart of
sres_tpu/ops/winograd.py).

Y = Aᵀ[(G g Gᵀ) ⊙ (Bᵀ d B)]A per m×m output tile: n² = (m+2)² tap products
replace 9·m² MACs, and over channels each tap product is a (tiles, Cin) @
(Cin, Cout) matrix product. The quad-plane layout and the compensated
double-f32 weight programs of the JAX module exist for the TPU (lane
layout, bitwise constant folding) and are not carried over: here the
weight transform is evaluated in float64 and cast to f32 once per weight
load.

Weights are in torch layout, (Cout, Cin, 3, 3); transformed weights are
(n², Cin, Cout) with tap index ti·n + tj (ti the row tap).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# F(2x2, 3x3) — Lavin & Gray (2015)
_BT2 = np.array([[1, 0, -1, 0],
                 [0, 1, 1, 0],
                 [0, -1, 1, 0],
                 [0, 1, 0, -1]], np.float64)
_G2 = np.array([[1, 0, 0],
                [0.5, 0.5, 0.5],
                [0.5, -0.5, 0.5],
                [0, 0, 1]], np.float64)
_AT2 = np.array([[1, 1, 1, 0],
                 [0, 1, -1, -1]], np.float64)

# F(4x4, 3x3)
_BT4 = np.array([[4, 0, -5, 0, 1, 0],
                 [0, -4, -4, 1, 1, 0],
                 [0, 4, -4, -1, 1, 0],
                 [0, -2, -1, 2, 1, 0],
                 [0, 2, -1, -2, 1, 0],
                 [0, 4, 0, -5, 0, 1]], np.float64)
_G4 = np.array([[1 / 4, 0, 0],
                [-1 / 6, -1 / 6, -1 / 6],
                [-1 / 6, 1 / 6, -1 / 6],
                [1 / 24, 1 / 12, 1 / 6],
                [1 / 24, -1 / 12, 1 / 6],
                [0, 0, 1]], np.float64)
_AT4 = np.array([[1, 1, 1, 1, 1, 0],
                 [0, 1, -1, 2, -2, 0],
                 [0, 1, 1, 4, 4, 0],
                 [0, 1, -1, 8, -8, 1]], np.float64)

MATS = {2: (_BT2, _G2, _AT2), 4: (_BT4, _G4, _AT4)}


def check_geometry(m: int, h: int, w: int) -> None:
    """The checks of sres_tpu/ops/winograd.py:wino_spec (:110-119)."""
    if m not in MATS:
        raise ValueError(f"Winograd tile m must be one of {sorted(MATS)}, got {m}")
    if h % m or w % m:
        raise ValueError(f"H={h}, W={w} must be multiples of the tile size {m}")


def transform_weights(w: torch.Tensor, m: int) -> torch.Tensor:
    """(Cout, Cin, 3, 3) → (n², Cin, Cout) f32: U[ti·n+tj] = (G w Gᵀ)[ti, tj],
    evaluated in float64 (correctly rounded to f32 up to ties)."""
    if m not in MATS:
        raise ValueError(f"Winograd tile m must be one of {sorted(MATS)}, got {m}")
    n = m + 2
    g = torch.from_numpy(MATS[m][1]).to(w.device)
    u = torch.einsum("tp,sq,oipq->tsio", g, g, w.detach().double())
    return u.reshape(n * n, w.shape[1], w.shape[0]).float()


def wino_conv_ref(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  m: int) -> torch.Tensor:
    """Plain einsum Winograd conv on NCHW in f32 (SAME, stride 1, 3×3) — the
    math oracle (counterpart of sres_tpu/ops/winograd.py:wino_conv_ref :361).
    ``w`` is (Cout, Cin, 3, 3). Materialises every tap; tests only."""
    t, c, h, wd = x.shape
    check_geometry(m, h, wd)
    n = m + 2
    bt, g, at = (torch.from_numpy(a).float().to(x.device) for a in MATS[m])
    xp = F.pad(x.float(), (1, 1, 1, 1))
    d = xp.unfold(2, n, m).unfold(3, n, m)          # (t, c, th, tw, p, q)
    v = torch.einsum("ip,jq,tcrspq->ijtrsc", bt, bt, d)
    u = torch.einsum("tp,sq,oipq->tsio", g, g, w.float())
    mm = torch.einsum("ijtrsc,ijco->ijtrso", v, u)
    y = torch.einsum("ui,vj,ijtrso->torusv", at, at, mm)
    y = y.reshape(t, w.shape[0], h, wd)
    if b is not None:
        y = y + b.float()[None, :, None, None]
    return y
