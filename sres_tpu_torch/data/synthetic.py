"""Procedural synthetic ocean-field source — the test/bench dataset
(counterpart of sres_tpu/data/synthetic.py:1-78; the reference has no
offline-testable source, SURVEY.md §4).

Generates smooth multi-scale sinusoid fields with temporal drift and a static
NaN "land" mask so the full NaN-tile-filtering / normalization / training
pipeline runs without real SWOT data. The same seed gives the JAX package's
fields bit for bit. ``write_swot_fixture`` waits for the SWOT reader.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from sres_tpu_torch.config import cfg
from sres_tpu_torch.data.region_loader import RegionTileLoader


def _field(rng: np.random.Generator, ny: int, nx: int, t: float, ncomp: int = 8) -> np.ndarray:
    yy, xx = np.meshgrid(np.linspace(0, 1, ny), np.linspace(0, 1, nx), indexing="ij")
    out = np.zeros((ny, nx), np.float32)
    for _ in range(ncomp):
        fy, fx = rng.uniform(1, 12, 2)
        phase = rng.uniform(0, 2 * np.pi) + t * rng.uniform(0.1, 1.0)
        amp = rng.uniform(0.2, 1.0)
        out += (amp * np.sin(2 * np.pi * (fy * yy + fx * xx) + phase)).astype(np.float32)
    return out


def _land_mask(rng: np.random.Generator, ny: int, nx: int, frac: float) -> np.ndarray:
    """Static low-frequency blob mask covering ~frac of the region (a couple
    of large contiguous 'continents' so plenty of tiles stay land-free)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, ny), np.linspace(0, 1, nx), indexing="ij")
    base = np.zeros((ny, nx), np.float32)
    for _ in range(3):
        fy, fx = rng.uniform(0.5, 2.0, 2)
        phase = rng.uniform(0, 2 * np.pi)
        base += np.sin(2 * np.pi * (fy * yy + fx * xx) + phase).astype(np.float32)
    thresh = np.quantile(base, 1.0 - frac)
    return base > thresh


class SyntheticDataLoader(RegionTileLoader):
    def __init__(self, task, **kwargs):
        super().__init__(task, **kwargs)
        ds = cfg().dataset
        self.ny = int(ds.image_size["y"])
        self.nx = int(ds.image_size["x"])
        self.ntimes = int(ds.ntimes)
        self.nan_fraction = float(ds.get("nan_fraction", 0.0))
        self.seed = int(ds.get("seed", 0))
        mask_rng = np.random.default_rng(self.seed + 999)
        self.mask = _land_mask(mask_rng, self.ny, self.nx, self.nan_fraction) \
            if self.nan_fraction > 0 else None
        self._cache: Dict = {}

    def get_dset_time_indices(self) -> List[int]:
        return list(range(self.ntimes))

    def load_region(self, varname: str, time_index: int) -> np.ndarray:
        key = (varname, time_index)
        if key not in self._cache:
            # stable across processes (Python's hash() is randomized per run)
            import zlib
            vseed = self.seed + zlib.crc32(varname.encode()) % 10_000
            rng = np.random.default_rng(vseed)  # same spatial modes every t
            data = _field(rng, self.ny, self.nx, float(time_index))
            offset = {"SST": 15.0, "SSS": 35.0}.get(varname, 0.0)
            data = data * 2.0 + offset
            if self.mask is not None:
                data = data.copy()
                data[self.mask] = np.nan
            self._cache[key] = data.astype(np.float32)
        return self._cache[key]
