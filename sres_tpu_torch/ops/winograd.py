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

from functools import lru_cache
from typing import List, Optional

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


@lru_cache(maxsize=None)
def device_g(m: int, device: torch.device) -> torch.Tensor:
    """G of F(m, 3) (float64) on ``device``, made once per (m, device) and
    kept: a train step transforms weights and weight gradients hundreds of
    times, and each copy from pageable host memory would wait for the
    stream's queued work. Made outside inference mode."""
    with torch.inference_mode(False):
        return torch.from_numpy(MATS[m][1]).to(device)


def check_geometry(m: int, h: int, w: int) -> None:
    """The checks of sres_tpu/ops/winograd.py:wino_spec (:110-119)."""
    if m not in MATS:
        raise ValueError(f"Winograd tile m must be one of {sorted(MATS)}, got {m}")
    if h % m or w % m:
        raise ValueError(f"H={h}, W={w} must be multiples of the tile size {m}")


# ----------------------------------------------- factored transform programs
# The straight-line programs of sres_tpu/ops/winograd.py:169-224, in the
# same operation order, on lists of tensors (one per transform index).
def bt_apply(m: int, f: List[torch.Tensor]) -> List[torch.Tensor]:
    """out[i] = Σ_q BT[i, q]·f[q]."""
    if m == 4:
        p = f[4] - 4.0 * f[2]
        q = 4.0 * f[1] - f[3]
        s = f[4] - f[2]
        t = 2.0 * (f[1] - f[3])
        return [4.0 * f[0] - 5.0 * f[2] + f[4], p - q, p + q, s - t, s + t,
                4.0 * f[1] - 5.0 * f[3] + f[5]]
    return [f[0] - f[2], f[1] + f[2], f[2] - f[1], f[1] - f[3]]


def bt_t_apply(m: int, f: List[torch.Tensor]) -> List[torch.Tensor]:
    """out[q] = Σ_i BT[i, q]·f[i] (the dx adjoint, :183)."""
    if m == 4:
        u, v = f[1] + f[2], f[1] - f[2]
        w, z = f[3] + f[4], f[3] - f[4]
        return [4.0 * f[0], 4.0 * (f[5] - v) - 2.0 * z,
                -5.0 * f[0] - 4.0 * u - w, v + 2.0 * z - 5.0 * f[5],
                f[0] + u + w, f[5]]
    return [f[0], f[1] - f[2] + f[3], f[1] + f[2] - f[0], -f[3]]


def at_apply(m: int, f: List[torch.Tensor]) -> List[torch.Tensor]:
    """out[u] = Σ_i AT[u, i]·f[i] (n inputs → m outputs)."""
    if m == 4:
        s1, d1 = f[1] + f[2], f[1] - f[2]
        s2, d2 = f[3] + f[4], f[3] - f[4]
        return [f[0] + s1 + s2, d1 + 2.0 * d2, s1 + 4.0 * s2,
                d1 + 8.0 * d2 + f[5]]
    return [f[0] + f[1] + f[2], f[1] - f[2] - f[3]]


def at_t_apply(m: int, f: List[torch.Tensor]) -> List[torch.Tensor]:
    """out[i] = Σ_u AT[u, i]·f[u] (m inputs → n outputs; the dM adjoint,
    :215)."""
    if m == 4:
        s, t = f[0] + f[2], f[1] + f[3]
        u, v = f[0] + 4.0 * f[2], 2.0 * f[1] + 8.0 * f[3]
        return [f[0], s + t, s - t, u + v, u - v, f[3]]
    return [f[0], f[0] + f[1], f[0] - f[1], -f[1]]


def transform_weights(w: torch.Tensor, m: int) -> torch.Tensor:
    """(..., Cout, Cin, 3, 3) → (..., n², Cin, Cout) f32: U[ti·n+tj] =
    (G w Gᵀ)[ti, tj], evaluated in float64 (correctly rounded to f32 up to
    ties); leading dimensions are a batch of kernels."""
    if m not in MATS:
        raise ValueError(f"Winograd tile m must be one of {sorted(MATS)}, got {m}")
    n = m + 2
    g = device_g(m, w.device)
    u = torch.einsum("tp,sq,...oipq->...tsio", g, g, w.double())
    return u.reshape(*w.shape[:-4], n * n, w.shape[-3], w.shape[-4]).float()


def untransform_weight_grad(du: torch.Tensor, m: int) -> torch.Tensor:
    """Adjoint of ``transform_weights``: dU (..., n², Cin, Cout) → dw (...,
    Cout, Cin, 3, 3) f32, dw[o, i] = Gᵀ·dU[·, ·, i, o]·G evaluated in float64
    (counterpart of sres_tpu/ops/winograd.py:untransform_weight_grad :334,
    whose compensated double-f32 form only matches XLA constant folding)."""
    if m not in MATS:
        raise ValueError(f"Winograd tile m must be one of {sorted(MATS)}, got {m}")
    n = m + 2
    g = device_g(m, du.device)
    d = du.double().reshape(*du.shape[:-3], n, n, *du.shape[-2:])
    return torch.einsum("tp,sq,...tsio->...oipq", g, g, d).float()


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
