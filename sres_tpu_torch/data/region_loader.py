"""Region → tiles loader base (counterpart of
sres_tpu/data/region_loader.py), under the synthetic and SWOT sources.

Factors the reference SWOTRawDataLoader's tiling/normalization machinery
(sres/base/source/swot/raw.py:147-233) out of the file-format specifics:
subclasses implement ``load_region(varname, time_index) -> (y, x) ndarray``
and ``get_dset_time_indices()``; this base handles the active-region crop,
NaN-tile filtering, the timeslice cache, batch selection and normalization.

Deviation from the reference (documented bug fix): for multi-channel tasks
the reference's ``get_tiles`` flattens tiles channel-major and then regroups
consecutive *tiles* as channels (raw.py:225-230), scrambling SSS/SST pairing.
Here tiles are cut per-channel and stacked on a channel axis so
(tiles, channels, y, x) is always correctly paired.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from sres_tpu_torch.config import cfg, config
from sres_tpu_torch.data.norm import NormStatsSidecar, normalize_batch
from sres_tpu_torch.data.tiles import TileGrid
from sres_tpu_torch.util.larray import LArray
from sres_tpu_torch.util.logging import lgm


class RegionTileLoader:
    #: timeslices kept in the host-side cache (current + prefetched next)
    CACHE_SLOTS = 2

    def __init__(self, task, **kwargs):
        self.task = task
        self.varnames: Dict[str, str] = dict(task.input_variables)
        self.tile_grid = TileGrid(task)
        self.time_index: int = -1
        self.timeslice: Optional[LArray] = None
        self._cache: "dict[int, LArray]" = {}
        import threading
        self._lock = threading.Lock()
        cache_dir = f"{cfg().platform.cache}/norm_data/norms"
        self.sidecar = NormStatsSidecar(f"{cache_dir}/norms.{config().get('dataset', 'dataset')}.npz")

    # -- subclass interface ---------------------------------------------------
    def load_region(self, varname: str, time_index: int) -> np.ndarray:
        raise NotImplementedError

    def get_dset_time_indices(self) -> List[int]:
        raise NotImplementedError

    def get_dset_size(self) -> int:
        return len(self.get_dset_time_indices())

    # -- region → tiles ---------------------------------------------------------
    def load_region_data(self, time_index: int, **kwargs) -> LArray:
        """The raw (C, Y, X) region of a timestep, NaN holes included; under
        the loader's lock, as every ``load_region`` call is."""
        with self._lock:
            raw = np.stack([self.load_region(v, time_index) for v in self.varnames], axis=0)
        return LArray(raw, ["channels", "y", "x"], coords=dict(channels=list(self.varnames)))

    def get_tiles(self, raw_data: np.ndarray) -> LArray:
        """(C, Y, X) region → (ntiles, C, ty, tx) NaN-free tiles with their
        flat grid ids as the 'tiles' coord (reference: raw.py:216-233)."""
        nch = raw_data.shape[0]
        ts = self.tile_grid.get_full_tile_size()
        ishape = dict(c=nch, y=raw_data.shape[1], x=raw_data.shape[2])
        grid_shape = self.tile_grid.get_grid_shape(image_shape=ishape)
        roi = self.tile_grid.get_active_region(image_shape=ishape)
        region = raw_data[..., roi["y"][0]:roi["y"][1], roi["x"][0]:roi["x"][1]]
        tiled = region.reshape(nch, grid_shape["y"], ts["y"], grid_shape["x"], ts["x"])
        tiled = tiled.swapaxes(2, 3).reshape(nch, grid_shape["y"] * grid_shape["x"], ts["y"], ts["x"])
        tiled = tiled.swapaxes(0, 1)  # (tiles, channels, ty, tx)
        finite = np.isfinite(tiled.mean(axis=(1, 2, 3)))  # drop tiles w/ any NaN in any channel
        kept = tiled[finite]
        tile_ids = np.arange(tiled.shape[0])[finite]
        lgm().log(f"get_tiles: kept {kept.shape[0]}/{tiled.shape[0]} tiles, grid={grid_shape}")
        return LArray(kept.astype(np.float32), ["tiles", "channels", "y", "x"],
                      coords=dict(tiles=tile_ids, channels=list(self.varnames)),
                      attrs=dict(grid_shape=grid_shape))

    def _load_tiles(self, time_index: int) -> LArray:
        """Cached region→tiles load; thread-safe so a prefetch worker can warm
        the next timeslice while the device trains on the current one."""
        # one coarse lock: load_region mutates cfg().dataset for filename
        # templating, so concurrent loads must serialize; a waiter for the
        # same index finds it cached when the prefetch worker finishes
        with self._lock:
            if time_index in self._cache:
                return self._cache[time_index]
            raw = np.stack([self.load_region(v, time_index) for v in self.varnames], axis=0)
            tiles = self.get_tiles(raw)
            self._cache[time_index] = tiles
            while len(self._cache) > self.CACHE_SLOTS:
                evict = next(k for k in self._cache if k != time_index)
                del self._cache[evict]
            return tiles

    def load_timeslice(self, time_index: int, **kwargs) -> LArray:
        self.timeslice = self._load_tiles(time_index)
        self.time_index = time_index
        return self.timeslice

    def prefetch_timeslice(self, time_index: int) -> None:
        """Warm the cache without moving the current-timeslice pointer."""
        self._load_tiles(time_index)

    # -- batch + norm -----------------------------------------------------------
    def _timeslice_iter(self):
        """Side-effect-free pass over every timeslice for sidecar stats.

        Must NOT touch ``self.timeslice``/``self.time_index``: the sidecar is
        computed lazily from inside ``select_batch`` on the first normalized
        batch, and moving the current-timeslice pointer there would silently
        swap which tiles the remaining batches of the epoch train on
        (reference computes stats without the pointer too:
        sres/base/source/swot/raw.py:89-106)."""
        for t in self.get_dset_time_indices():
            yield self._load_tiles(t)

    def select_batch(self, tile_range: Tuple[int, int]) -> Optional[LArray]:
        ntiles = self.timeslice.shape[0]
        if tile_range[0] >= ntiles:
            return None
        end = min(tile_range[1], ntiles)
        batch = self.timeslice.isel(tiles=slice(tile_range[0], end))
        return self.norm(batch, (tile_range[0], end))

    def norm(self, batch: LArray, tile_range: Tuple[int, int]) -> LArray:
        ntype: str = cfg().task.norm
        sidecar_stats = global_stats = None
        if ntype in ("tnorm", "tscale"):
            sidecar_stats = self.sidecar.get(self._timeslice_iter)
        elif ntype in ("gnorm", "gscale"):
            global_stats = self.sidecar.global_stats(self._timeslice_iter)
        data, stats = normalize_batch(batch.data, ntype, tile_range,
                                      sidecar_stats, global_stats, list(self.varnames))
        out = batch.copy(data=data)
        out.attrs.update(stats)
        return out
