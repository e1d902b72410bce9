"""LLC4320 Cape Basin per-timestep .npy source (counterpart of
sres_tpu/data/s3export.py; reference sres/base/source/s3export/batch.py).

Each (variable, time index) is one ``hr_{var}_{index:04d}.npy`` grid; files
are numbered from 1. Tiles and domains are cut by pixel origin + size,
values min-max scaled from ``task.variable_ranges``. Used with
batch_domain='time': the batch axis is a contiguous time-index range at one
tile location (``load_index_batch``).
"""
from __future__ import annotations

from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from sres_tpu_torch.config import cfg
from sres_tpu_torch.util.larray import LArray
from sres_tpu_torch.util.logging import lgm


class S3ExportDataLoader:
    def __init__(self, task, tile_size: Dict[str, int], **kwargs):
        self.task = task
        self.tile_size = tile_size          # HR (scaled) tile size
        self.varnames: Dict[str, str] = dict(task.input_variables)
        self.use_memmap = bool(task.get("use_memmap", False))
        self.shape: Optional[List[int]] = None

    def _filepath(self, varname: str, index: int) -> str:
        cfg().dataset["varname"] = varname
        cfg().dataset["index"] = f"{index:04}"
        return f"{cfg().dataset.dataset_root}/{cfg().dataset.dataset_files}"

    def _glob(self, varname: str) -> str:
        cfg().dataset["varname"] = varname
        cfg().dataset["index"] = "*"
        return f"{cfg().dataset.dataset_root}/{cfg().dataset.dataset_files}"

    def get_dset_size(self) -> int:
        vn = list(self.varnames)[0]
        return len(glob(self._glob(vn)))

    def get_dset_time_indices(self) -> List[int]:
        return list(range(self.get_dset_size()))

    def scale(self, varname: str, data: np.ndarray) -> np.ndarray:
        vrange = cfg().task.variable_ranges[varname]
        return (data - vrange["min"]) / (vrange["max"] - vrange["min"])

    def open_timeslice(self, varname: str, index: int) -> np.ndarray:
        fpath = self._filepath(varname, index + 1)  # files are 1-based
        raw = np.load(fpath, allow_pickle=True, mmap_mode="r" if self.use_memmap else None)
        if self.shape is None:
            self.shape = list(raw.shape)
            lgm().log(f"Loaded {varname}({index}): shape={self.shape}")
        return raw

    def cut_tile(self, grid: np.ndarray, origin: Dict[str, int]) -> np.ndarray:
        return grid[origin["y"]:origin["y"] + self.tile_size["y"],
                    origin["x"]:origin["x"] + self.tile_size["x"]]

    def cut_domain(self, grid: np.ndarray) -> np.ndarray:
        origin = cfg().task.origin
        tg = cfg().task.tile_grid
        return grid[origin["y"]:origin["y"] + self.tile_size["y"] * tg["y"],
                    origin["x"]:origin["x"] + self.tile_size["x"] * tg["x"]]

    def load_global_timeslice(self, varname: str, index: int = 0) -> np.ndarray:
        return self.cut_domain(np.asarray(self.open_timeslice(varname, index)))

    def load_channel(self, varname: str, index: int,
                     origin: Optional[Dict[str, int]]) -> np.ndarray:
        raw = self.open_timeslice(varname, index)
        tile = self.cut_tile(np.asarray(raw), origin) if origin is not None else np.asarray(raw)
        return self.scale(varname, tile)

    def load_timeslice_stack(self, index: int, origin: Optional[Dict[str, int]]) -> np.ndarray:
        return np.stack([self.load_channel(v, index, origin) for v in self.varnames], axis=0)

    def load_index_batch(self, ctile: Dict[str, int], index_range: Tuple[int, int]) -> LArray:
        """(T, C, y, x) over the consecutive time indices of ``index_range``
        at the tile whose HR origin is ``ctile``."""
        slices = [self.load_timeslice_stack(i, ctile) for i in range(*index_range)]
        data = np.stack(slices, axis=0).astype(np.float32)  # (T, C, y, x)
        return LArray(data, ["tiles", "channels", "y", "x"],
                      coords=dict(tiles=np.arange(*index_range), channels=list(self.varnames)))

    def load_region_data(self, time_index: int, **kwargs) -> LArray:
        data = np.stack([self.scale(v, self.load_global_timeslice(v, time_index))
                         for v in self.varnames], axis=0)
        return LArray(data.astype(np.float32), ["channels", "y", "x"],
                      coords=dict(channels=list(self.varnames)))
