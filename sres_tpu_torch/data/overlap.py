"""Overlapped tile extraction for seam-free full-region inference
(counterpart of sres_tpu/data/overlap.py).

The reference (and our default path) super-resolves grid tiles independently
and mosaics them, which leaves visible seams at tile borders — each tile's
conv receptive field is cut off at its edge. This module extracts tiles with
a reflected margin so the SR network sees real context across borders; after
upsampling, the margins are cropped and the centers assembled, eliminating
seams (SURVEY.md §5.7's "halo" capability, realized as halo *extraction*:
tiles stay independent, so they run as one batch).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def reflect_pad_region(region: np.ndarray, margin: int) -> np.ndarray:
    """(C, Y, X) → reflected-pad by ``margin`` on both spatial axes."""
    return np.pad(region, ((0, 0), (margin, margin), (margin, margin)), mode="reflect")


def extract_overlapped_tiles(region: np.ndarray, tile_hw: Dict[str, int],
                             grid_shape: Dict[str, int], margin: int
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Cut (C, Y, X) into (ntiles, C, ty+2m, tx+2m) windows centered on the
    regular tile grid (reflect-padded borders). Tiles whose *central* ty×tx
    area contains NaN are dropped (same filter as the grid path); remaining
    margin NaNs (coastlines) are filled with the tile's central mean so the
    network input is finite.

    Returns (tiles, kept_flat_ids).
    """
    ty, tx = tile_hw["y"], tile_hw["x"]
    gy, gx = grid_shape["y"], grid_shape["x"]
    padded = reflect_pad_region(region, margin)
    tiles, ids = [], []
    for iy in range(gy):
        for ix in range(gx):
            win = padded[:, iy * ty: iy * ty + ty + 2 * margin,
                         ix * tx: ix * tx + tx + 2 * margin]
            center = win[:, margin:margin + ty, margin:margin + tx]
            if not np.isfinite(center).all():
                continue
            if not np.isfinite(win).all():
                win = win.copy()
                fill = center.mean(axis=(1, 2), keepdims=True)
                win = np.where(np.isfinite(win), win, fill)
            tiles.append(win)
            ids.append(iy * gx + ix)
    if not tiles:
        return np.zeros((0, region.shape[0], ty + 2 * margin, tx + 2 * margin),
                        np.float32), np.zeros((0,), np.int64)
    return np.stack(tiles).astype(np.float32), np.asarray(ids, np.int64)
