"""Normalization: the six schemes, the per-tile stats sidecar, ``denorm``
and the per-pixel maps of whole-region inference (counterpart of
sres_tpu/data/norm.py; reference sres/base/source/swot/raw.py:46-123,169-214,
sres/controller/dual_trainer.py:67-77).

Schemes (cfg().task.norm):
  lnorm  — per-tile, per-channel mean/std over (y,x); stats attached for denorm
  lscale — per-tile min/max → [0,1]; stats attached
  gnorm  — global (sidecar-averaged) mean / sqrt(mean var); no stats attached
  gscale — global min/max; no stats attached
  tnorm  — per-tile *time-averaged* sidecar mean/var, indexed by tile position
  tscale — per-tile sidecar min/max

Stats ride along as ``attrs['mean'|'std'|'max'|'min']`` arrays of shape
(B, C, 1, 1) on the batch LArray, for the denormalization of inference
results. Deviation from the reference:
``tscale`` slices the sidecar by the batch tile range like ``tnorm`` does —
the reference broadcasts all-tile stats, which only works for full-timeslice
batches.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from sres_tpu_torch.util.logging import lgm

STATS = ("mean", "var", "max", "min")


class NormStatsSidecar:
    """Per-(variable, tile) mean/var/max/min accumulated over every timestep,
    cached on disk (reference computed+cached this as
    ``{cache}/norm_data/norms/norms.{dataset}.nc``; we cache an .npz with the
    same path stem)."""

    def __init__(self, cache_path: str):
        self.cache_path = cache_path
        self._stats: Optional[Dict[str, np.ndarray]] = None  # var → (ntiles, 4)

    def load(self) -> Optional[Dict[str, np.ndarray]]:
        if os.path.exists(self.cache_path):
            with np.load(self.cache_path) as z:
                return {k: z[k] for k in z.files}
        return None

    def save(self, stats: Dict[str, np.ndarray]) -> None:
        os.makedirs(os.path.dirname(self.cache_path), exist_ok=True)
        np.savez(self.cache_path, **stats)
        lgm().log(f"Wrote norm stats to {self.cache_path}")

    def compute(self, timeslice_iter) -> Dict[str, np.ndarray]:
        """``timeslice_iter`` yields tile LArrays (tiles, channels, y, x).
        Accumulates mean-of-means, mean-of-vars, max, min per (var, tile)."""
        acc: Dict[str, List[np.ndarray]] = {}
        varnames: List[str] = []
        for tiles in timeslice_iter:
            varnames = list(tiles.coords["channels"])
            d = tiles.data  # (T, C, y, x), NaN-free tiles
            means = d.mean(axis=(2, 3))
            vars_ = d.var(axis=(2, 3))
            maxs = d.max(axis=(2, 3))
            mins = d.min(axis=(2, 3))
            acc.setdefault("mean", []).append(means)
            acc.setdefault("var", []).append(vars_)
            acc.setdefault("max", []).append(maxs)
            acc.setdefault("min", []).append(mins)
        stats: Dict[str, np.ndarray] = {}
        for iv, vn in enumerate(varnames):
            per_stat = [
                np.stack([a[:, iv] for a in acc["mean"]]).mean(axis=0),
                np.stack([a[:, iv] for a in acc["var"]]).mean(axis=0),
                np.stack([a[:, iv] for a in acc["max"]]).max(axis=0),
                np.stack([a[:, iv] for a in acc["min"]]).min(axis=0),
            ]
            stats[vn] = np.stack(per_stat, axis=1)  # (ntiles, 4)
        return stats

    def get(self, timeslice_iter_fn) -> Dict[str, np.ndarray]:
        if self._stats is None:
            self._stats = self.load()
            if self._stats is None:
                lgm().log(f"Computing norm stats (no cache at {self.cache_path})", display=True)
                self._stats = self.compute(timeslice_iter_fn())
                self.save(self._stats)
        return self._stats

    def global_stats(self, timeslice_iter_fn) -> Dict[str, np.ndarray]:
        """Globalized per-variable (4,) stats: mean over tiles for mean/var,
        max/min over tiles for max/min (reference globalize_norm: raw.py:23)."""
        per_tile = self.get(timeslice_iter_fn)
        out = {}
        for vn, s in per_tile.items():
            out[vn] = np.array([s[:, 0].mean(), s[:, 1].mean(), s[:, 2].max(), s[:, 3].min()])
        return out


def normalize_batch(
    batch: np.ndarray,
    ntype: str,
    tile_range: Tuple[int, int],
    sidecar_stats: Optional[Dict[str, np.ndarray]] = None,
    global_stats: Optional[Dict[str, np.ndarray]] = None,
    varnames: Optional[List[str]] = None,
) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Normalize an NaN-free (B, C, y, x) batch. Returns (normalized, attrs)
    where attrs holds the (B, C, 1, 1) stats needed by denorm."""
    b, c = batch.shape[:2]
    attrs: Dict[str, np.ndarray] = {}
    out = np.empty_like(batch, dtype=np.float32)
    for ic in range(c):
        ch = batch[:, ic]
        if ntype == "lnorm":
            # xarray .std() defaults to ddof=0 — match the reference exactly
            mean = ch.mean(axis=(1, 2), keepdims=True)
            std = ch.std(axis=(1, 2), keepdims=True)
            out[:, ic] = (ch - mean) / std
            attrs.setdefault("mean", []).append(mean.reshape(b, 1, 1, 1))
            attrs.setdefault("std", []).append(std.reshape(b, 1, 1, 1))
        elif ntype == "lscale":
            mx = ch.max(axis=(1, 2), keepdims=True)
            mn = ch.min(axis=(1, 2), keepdims=True)
            out[:, ic] = (ch - mn) / (mx - mn)
            attrs.setdefault("max", []).append(mx.reshape(b, 1, 1, 1))
            attrs.setdefault("min", []).append(mn.reshape(b, 1, 1, 1))
        elif ntype == "gnorm":
            g = global_stats[varnames[ic]]
            out[:, ic] = (ch - g[0]) / np.sqrt(g[1])
        elif ntype == "gscale":
            g = global_stats[varnames[ic]]
            out[:, ic] = (ch - g[3]) / (g[2] - g[3])
        elif ntype == "tnorm":
            s = sidecar_stats[varnames[ic]][tile_range[0]:tile_range[1]]
            mean = s[:, 0].reshape(-1, 1, 1)
            std = np.sqrt(s[:, 1]).reshape(-1, 1, 1)
            out[:, ic] = (ch - mean) / std
            attrs.setdefault("mean", []).append(mean.reshape(b, 1, 1, 1))
            attrs.setdefault("std", []).append(std.reshape(b, 1, 1, 1))
        elif ntype == "tscale":
            s = sidecar_stats[varnames[ic]][tile_range[0]:tile_range[1]]
            mx = s[:, 2].reshape(-1, 1, 1)
            mn = s[:, 3].reshape(-1, 1, 1)
            out[:, ic] = (ch - mn) / (mx - mn)
            attrs.setdefault("max", []).append(mx.reshape(b, 1, 1, 1))
            attrs.setdefault("min", []).append(mn.reshape(b, 1, 1, 1))
        else:
            raise ValueError(f"Unknown norm: {ntype}")
    stats = {k: np.concatenate(v, axis=1).astype(np.float32) for k, v in attrs.items()}
    return out, stats


def denorm(normed: np.ndarray, norm_attrs: Dict[str, np.ndarray]) -> np.ndarray:
    """Invert lnorm/lscale/tnorm/tscale via the attached batch stats
    (reference: sres/controller/dual_trainer.py:67-77)."""
    out = np.asarray(normed)
    if "mean" in norm_attrs:
        out = out * norm_attrs["std"] + norm_attrs["mean"]
    if "max" in norm_attrs:
        rng = norm_attrs["max"] - norm_attrs["min"]
        out = out * rng + norm_attrs["min"]
    return out


def slice_stats(stats: Dict[str, np.ndarray], chan_idx) -> Dict[str, np.ndarray]:
    """Channel-select (B, C, 1, 1) batch stats — denorm of target panels when
    target_variables ⊂ input_variables (the model/interp/target tensors carry
    only the target channels)."""
    return {k: v[:, list(chan_idx)] for k, v in stats.items()}


def tile_stats_maps(grid_valid_ids: np.ndarray, grid_shape: Dict[str, int],
                    tile_hw: Dict[str, int], region_hw: Tuple[int, int],
                    sidecar_stats: Dict[str, np.ndarray],
                    varnames: List[str], ntype: str
                    ) -> Dict[str, np.ndarray]:
    """Per-PIXEL normalization maps for whole-region inference under the
    sidecar schemes (tnorm/tscale): each tile's block of pixels gets its
    per-(var, tile) sidecar stats; positions whose tile was NaN-dropped (no
    sidecar row) get the variable's sidecar-global stats (they are NaN holes
    restored after inference anyway). Returns attrs shaped (1, C, Y, X) in
    denorm's convention ({mean,std} or {max,min}) so normalize = invert of
    denorm applies pixel-wise.

    Sidecar row k corresponds to the k-th VALID tile in raster order — the
    same static-valid-tile-set assumption the loader's batch path makes
    (reference swot/raw.py:216-233: the mask is static, so the valid set is
    time-invariant)."""
    gy, gx = grid_shape["y"], grid_shape["x"]
    ty, tx = tile_hw["y"], tile_hw["x"]
    ry, rx = region_hw
    nchan = len(varnames)
    row_of = {int(fid): k for k, fid in enumerate(grid_valid_ids)}
    a_name, b_name = ("mean", "std") if ntype == "tnorm" else ("max", "min")
    out = {a_name: np.zeros((1, nchan, ry, rx), np.float32),
           b_name: np.ones((1, nchan, ry, rx), np.float32)}
    for ic, vn in enumerate(varnames):
        s = sidecar_stats[vn]           # (nvalid, 4): mean, var, max, min
        gmean, gvar = s[:, 0].mean(), s[:, 1].mean()
        gmax, gmin = s[:, 2].max(), s[:, 3].min()
        for iy in range(gy):
            for ix in range(gx):
                k = row_of.get(iy * gx + ix)
                if ntype == "tnorm":
                    m = s[k, 0] if k is not None else gmean
                    sd = np.sqrt(s[k, 1] if k is not None else gvar)
                    vals = (m, sd)
                else:
                    mx = s[k, 2] if k is not None else gmax
                    mn = s[k, 3] if k is not None else gmin
                    vals = (mx, mn)
                ys, xs = slice(iy * ty, min((iy + 1) * ty, ry)), \
                    slice(ix * tx, min((ix + 1) * tx, rx))
                out[a_name][0, ic, ys, xs] = vals[0]
                out[b_name][0, ic, ys, xs] = vals[1]
    # denorm convention: {mean, std} multiplies/adds; {max, min} scales range
    if ntype == "tnorm":
        return {"mean": out["mean"], "std": out["std"]}
    return {"max": out["max"], "min": out["min"]}


def normalize_with_attrs(raw: np.ndarray, attrs: Dict[str, np.ndarray]) -> np.ndarray:
    """Forward normalization with denorm-convention attrs (exact inverse of
    ``denorm``): works with scalar per-tile stats or per-pixel maps."""
    out = np.asarray(raw, np.float32)
    if "mean" in attrs:
        out = (out - attrs["mean"]) / attrs["std"]
    if "max" in attrs:
        out = (out - attrs["min"]) / (attrs["max"] - attrs["min"])
    return out
