"""Normalization: the six schemes + the per-tile stats sidecar (counterpart
of sres_tpu/data/norm.py:1-150; reference
sres/base/source/swot/raw.py:46-123,169-214). ``denorm`` and the per-pixel
maps of whole-region inference wait for the inference slice.

Schemes (cfg().task.norm):
  lnorm  — per-tile, per-channel mean/std over (y,x); stats attached for denorm
  lscale — per-tile min/max → [0,1]; stats attached
  gnorm  — global (sidecar-averaged) mean / sqrt(mean var); no stats attached
  gscale — global min/max; no stats attached
  tnorm  — per-tile *time-averaged* sidecar mean/var, indexed by tile position
  tscale — per-tile sidecar min/max

Stats ride along as ``attrs['mean'|'std'|'max'|'min']`` arrays of shape
(B, C, 1, 1) on the batch LArray, for the denormalization of inference
results (with the inference slice). Deviation from the reference:
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
