"""Batch assembly: source dispatch, augmentation, and the BatchDataset facade
the trainer consumes (counterpart of sres_tpu/data/batch.py; reference
sres/base/source/batch.py:241-315, sres/base/source/loader/batch.py:56-66,
sres/data/batch.py).

Source dispatch is by dataset-name prefix exactly like the reference:
``LLC4320*`` → S3ExportDataLoader (time-domain), ``swot*`` →
SWOTRawDataLoader (tiles-domain), ``synthetic*`` → SyntheticDataLoader.
``merra2*``, which ``sres_tpu`` serves by its own datapipe and not through
the SR trainer (its ``get_loader`` returns None), raises
``NotImplementedError`` (ROADMAP Queue 1 item 11).
The random 8-way flip/transpose augmentation (xyflip) runs on the host with
a seedable numpy Generator instead of the reference's process-global
``random`` so multi-host runs stay reproducible (SURVEY.md §7 hard parts).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Union

import numpy as np

from sres_tpu_torch.config import cfg
from sres_tpu_torch.data.s3export import S3ExportDataLoader
from sres_tpu_torch.data.swot import SWOTRawDataLoader
from sres_tpu_torch.data.synthetic import SyntheticDataLoader
from sres_tpu_torch.data.tiles import TileGrid, batchDomain
from sres_tpu_torch.util.larray import LArray

TimeType = Union[int]


def xyflip(batch: LArray, rng: np.random.Generator, enabled: bool,
           flip_index: Optional[int] = None) -> LArray:
    """Random 8-way dihedral augmentation over the last two axes
    (reference: source/batch.py:37-49). The flip index is recorded in attrs.
    ``flip_index`` overrides the sequential RNG draw — used by the grain
    input backend, where worker threads would race the shared generator."""
    data = batch.data
    if not enabled:
        flip_index = 0
    else:
        flip_index = int(rng.integers(0, 8)) if flip_index is None else int(flip_index)
        if flip_index % 2 == 1:
            data = np.flip(data, axis=-1)
        if (flip_index // 2) % 2 == 1:
            data = np.flip(data, axis=-2)
        if flip_index // 4 == 1:
            data = np.swapaxes(data, -1, -2)
    out = batch.copy(data=np.ascontiguousarray(data))
    out.attrs["xyflip"] = flip_index
    return out


def get_loader(task, tile_size: Dict[str, int], **kwargs):
    dset: str = task.dataset
    if dset.startswith("LLC4320"):
        return S3ExportDataLoader(task, tile_size, **kwargs)
    if dset.startswith("swot"):
        return SWOTRawDataLoader(task, **kwargs)
    if dset.startswith("synthetic"):
        return SyntheticDataLoader(task, **kwargs)
    if dset.startswith("merra2"):
        raise NotImplementedError(
            "the MERRA2 datapipe is not ported yet (ROADMAP Queue 1 item 11)")
    raise ValueError(f"No source loader for dataset '{dset}'")


class SRBatch:
    """Mid-layer batch assembler (reference: source/batch.py:241)."""

    def __init__(self, task, tile_size: Dict[str, int], seed: int = 0, **kwargs):
        self.tile_size = tile_size
        self.data_loader = get_loader(task, tile_size, **kwargs)
        self.batch_size: int = task.batch_size
        self.batch_domain = batchDomain.from_config(task.get("batch_domain", "tiles"))
        self.current_batch: Optional[LArray] = None
        self.channels: Optional[List[str]] = None
        self.rng = np.random.default_rng(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)

    def get_dset_time_indices(self) -> List[TimeType]:
        return self.data_loader.get_dset_time_indices()

    def get_dset_size(self) -> int:
        return self.data_loader.get_dset_size()

    def load_timeslice(self, ctime: TimeType, **kwargs) -> Optional[LArray]:
        return self.data_loader.load_timeslice(ctime, **kwargs)

    def load_region_data(self, ctime: TimeType, **kwargs) -> Optional[LArray]:
        return self.data_loader.load_region_data(ctime, **kwargs)

    def load_batch(self, ctile: Dict[str, int], ctime: TimeType,
                   flip_index: Optional[int] = None) -> Optional[LArray]:
        if self.batch_domain == batchDomain.Time:
            index_range = (ctime, ctime + self.batch_size)
            darray = self.data_loader.load_index_batch(ctile, index_range)
        elif self.batch_domain == batchDomain.Tiles:
            darray = self.data_loader.select_batch((ctile["start"], ctile["end"]))
        else:
            raise ValueError(f"Unknown batch_domain {self.batch_domain}")
        if darray is None:
            return None
        if self.channels is None:
            self.channels = list(darray.coords["channels"])
        return xyflip(darray, self.rng, bool(cfg().task.get("xyflip", False)),
                      flip_index=flip_index)

    def load(self, ctile: Dict[str, int], ctime: TimeType,
             flip_index: Optional[int] = None) -> Optional[LArray]:
        cbatch = self.load_batch(ctile, ctime, flip_index=flip_index)
        if cbatch is not None:
            self.current_batch = cbatch
        return cbatch


class BatchDataset:
    """The facade the trainer sees (reference: sres/data/batch.py:67)."""

    def __init__(self, task, seed: int = 0, **kwargs):
        self.task = task
        self.tile_grid = TileGrid(task)
        self.batch_size: int = task.batch_size
        self.downscale_factors = list(cfg().model.downscale_factors)
        self.scalefactor = math.prod(self.downscale_factors)
        self.tile_size = self.scale_coords(dict(task.tile_size))
        self.batch_domain = batchDomain.from_config(task.get("batch_domain", "tiles"))
        self.srbatch = SRBatch(task, self.tile_size, seed=seed, **kwargs)
        self.rng = np.random.default_rng(seed)
        self._seed = int(seed)

    def reseed(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)
        self.srbatch.reseed(seed + 1)
        self._seed = int(seed)

    def flip_index_for(self, ctime: TimeType, ctile: Dict[str, int]) -> int:
        """Deterministic per-tile xyflip index for parallel input backends
        (grain): derived from (seed, ctime, ctile) so it is stable under any
        worker count/order, unlike the sequential `srbatch.rng` draw."""
        key = [self._seed & 0xFFFFFFFF, int(ctime) & 0xFFFFFFFF]
        for k in sorted(ctile):
            key.append(int(ctile[k]) & 0xFFFFFFFF)
        return int(np.random.default_rng(key).integers(0, 8))

    def scale_coords(self, c: Dict[str, int]) -> Dict[str, int]:
        return {k: v * self.scalefactor for k, v in c.items()}

    def get_batch_array(self, ctile: Dict[str, int], ctime: TimeType,
                        rescale: bool = True, flip_index: Optional[int] = None,
                        **kwargs) -> Optional[LArray]:
        if self.batch_domain == batchDomain.Time and rescale:
            ctile = self.scale_coords(ctile)
        return self.srbatch.load(ctile, ctime, flip_index=flip_index)

    def get_current_batch_array(self) -> Optional[LArray]:
        return self.srbatch.current_batch

    def load_timeslice(self, ctime: TimeType, **kwargs) -> Optional[LArray]:
        return self.srbatch.load_timeslice(ctime, **kwargs)

    def load_region_data(self, ctime: TimeType, **kwargs) -> Optional[LArray]:
        return self.srbatch.load_region_data(ctime, **kwargs)

    def get_dset_time_indices(self) -> List[TimeType]:
        return self.srbatch.get_dset_time_indices()

    def get_batch_time_coords(self, shuffle: bool = True) -> List[TimeType]:
        """Epoch start coordinates: dataset time indices (tiles domain) or
        batch-size index strides (time domain), shuffled
        (reference: data/batch.py:178-196)."""
        if self.batch_domain == batchDomain.Time:
            nidx = self.srbatch.get_dset_size()
            start_coords: List[TimeType] = list(range(0, nidx - self.batch_size + 1, self.batch_size))
        else:
            start_coords = list(self.srbatch.get_dset_time_indices())
        if shuffle:
            self.rng.shuffle(start_coords)
        return start_coords
