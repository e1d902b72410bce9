"""Tile geometry and batch iteration (counterpart of sres_tpu/data/tiles.py;
reference sres/data/tiles.py).

TileGrid maps a region image onto a grid of fixed LR tiles (HR size =
tile_size × prod(downscale_factors)); iterators walk either fixed-size
slices of a timeslice's tile axis (batch_domain='tiles') or the grid tile
locations (batch_domain='time').
"""
from __future__ import annotations

import math
import random
from enum import Enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from sres_tpu_torch.config import cfg


class batchDomain(Enum):
    Time = "time"
    Tiles = "tiles"

    @classmethod
    def from_config(cls, sval: str) -> "batchDomain":
        return {"time": cls.Time, "tiles": cls.Tiles}[sval]


class TileGrid:
    def __init__(self, task=None, model=None):
        task = task if task is not None else cfg().task
        model = model if model is not None else cfg().model
        self.origin: Dict[str, int] = dict(task.get("origin", {}) or {})
        self.tile_size: Dict[str, int] = dict(task.tile_size)
        self.cfg_tile_grid: Dict[str, int] = dict(task.tile_grid)
        self.upsample_factor: int = math.prod(model.downscale_factors)
        self.tile_grid: Optional[Dict[str, int]] = None
        self.tlocs: Dict[Tuple[int, int], Dict[str, int]] = {}

    def get_full_tile_size(self) -> Dict[str, int]:
        return {d: self.tile_size[d] * self.upsample_factor for d in ("x", "y")}

    def get_tile_size(self, highres: bool = False) -> Dict[str, int]:
        sf = self.upsample_factor if highres else 1
        return {d: self.tile_size[d] * sf for d in ("x", "y")}

    def get_global_grid_shape(self, image_shape: Optional[Dict[str, int]] = None) -> Dict[str, int]:
        if image_shape is None:
            return dict(x=1, y=1)
        ts = self.get_full_tile_size()
        return {d: image_shape[d] // ts[d] for d in ("x", "y")}

    def get_grid_shape(self, image_shape: Optional[Dict[str, int]] = None) -> Dict[str, int]:
        glob = self.get_global_grid_shape(image_shape)
        self.tile_grid = {
            d: (self.cfg_tile_grid[d] if self.cfg_tile_grid[d] >= 0 else glob[d])
            for d in ("x", "y")
        }
        return self.tile_grid

    def get_active_region(self, image_shape: Optional[Dict[str, int]] = None) -> Dict[str, Tuple[int, int]]:
        ts = self.get_full_tile_size()
        gs = self.get_grid_shape(image_shape)
        o = {d: self.origin.get(d, 0) for d in ("x", "y")}
        return {d: (o[d], o[d] + ts[d] * gs[d]) for d in ("x", "y")}

    def get_tile_origin(self, ix: int, iy: int, highres: bool = False) -> Dict[str, int]:
        sf = self.upsample_factor if highres else 1
        c = dict(x=ix, y=iy)
        return {d: self.origin.get(d, 0) + c[d] * self.tile_size[d] * sf for d in ("x", "y")}

    def get_tile_locations(self, highres: bool = False,
                           selected_tile: Optional[Tuple[int, int]] = None,
                           **kwargs) -> Dict[Tuple[int, int], Dict[str, int]]:
        if not self.tlocs:
            if self.tile_grid is None:
                self.get_grid_shape(kwargs.get("image_shape"))
            for ix in range(self.tile_grid["x"]):
                for iy in range(self.tile_grid["y"]):
                    if selected_tile is None or (ix, iy) == selected_tile:
                        self.tlocs[(ix, iy)] = self.get_tile_origin(ix, iy, highres)
        return self.tlocs


class TileIterator:
    """Per-epoch batch iterator with a loss registry
    (reference: sres/data/tiles.py:8-45)."""

    def __init__(self, randomize: bool = False, rng: Optional[random.Random] = None, **kwargs):
        self.randomize = randomize
        self.rng = rng or random
        self._batch_losses: Dict[str, List[float]] = {}
        self.index = 0
        self.next_index = 0

    def register_loss(self, ltype: str, loss: float) -> None:
        self._batch_losses.setdefault(ltype, []).append(loss)

    def accumulate_loss(self, ltype: str) -> float:
        losses = self._batch_losses.get(ltype, [])
        self._batch_losses[ltype] = []
        return float(np.mean(losses)) if losses else float("nan")

    @classmethod
    def get_iterator(cls, **kwargs) -> "TileIterator":
        domain = batchDomain.from_config(cfg().task.get("batch_domain", "tiles"))
        if domain == batchDomain.Tiles:
            return TileBatchIterator(**kwargs)
        return TileGridIterator(**kwargs)


class TileBatchIterator(TileIterator):
    """Fixed-size slices over a timeslice's tile axis, optionally shuffled
    (batch_domain='tiles'; reference: tiles.py:48-74)."""

    def __init__(self, ntiles: int = 0, **kwargs):
        super().__init__(**kwargs)
        assert ntiles > 0, "Must provide ntiles for TileBatchIterator"
        self.batch_size: int = cfg().task.batch_size
        self.ntiles = ntiles
        self.batch_start_idxs: List[int] = list(range(0, ntiles, self.batch_size))
        if self.randomize:
            self.rng.shuffle(self.batch_start_idxs)

    def __iter__(self):
        self.next_index = 0
        return self

    def __next__(self) -> Dict[str, int]:
        if self.next_index >= len(self.batch_start_idxs):
            raise StopIteration()
        self.index = self.next_index
        bstart = self.batch_start_idxs[self.index]
        self.next_index += 1
        return dict(start=bstart, end=bstart + self.batch_size)


class TileGridIterator(TileIterator):
    """Walks TileGrid locations (batch_domain='time'; reference: tiles.py:76-98)."""

    def __init__(self, grid: Optional[TileGrid] = None, **kwargs):
        super().__init__(**kwargs)
        self.grid = grid or TileGrid()
        self.locations: List[Dict[str, int]] = list(self.grid.get_tile_locations(**{
            k: v for k, v in kwargs.items() if k in ("highres", "selected_tile", "image_shape")
        }).values())

    def __iter__(self):
        if self.randomize:
            self.rng.shuffle(self.locations)
        self.next_index = 0
        return self

    def __next__(self) -> Dict[str, int]:
        if self.next_index >= len(self.locations):
            raise StopIteration()
        self.index = self.next_index
        self.next_index += 1
        return self.locations[self.index]
