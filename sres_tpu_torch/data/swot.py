"""SWOT / MITgcm LLC4320 binary source (counterpart of sres_tpu/data/swot.py;
reference sres/base/source/swot/).

Files are flat big-endian float32 "shrunk" arrays holding values only at the
ocean points of the ``hFacC_k0.data`` mask template; the loader scatters them
back into the template (``native.decode_timestep``, compiled C++), reshapes
the 13-tile LLC layout into east/west hemisphere panels (``mds2d``,
reference swot/util.py:9-56), concatenates, and crops the configured pixel
ROI. Time indices are discovered by inverting the ``dataset_files`` filename
template over a directory glob.

``load_region`` mutates ``cfg().dataset`` for the filename templating, as
``sres_tpu``'s does; the base class calls it only under its lock, so a
prefetch thread's load never races another's. ``timers`` holds the seconds
of the loads by part: ``map`` (the template read and the scatter map, once),
``read`` (the value file), ``decode``, ``assemble`` (the hemisphere panels
and the global panel) and ``crop`` (the ROI).
"""
from __future__ import annotations

import re
import time
from collections import defaultdict
from glob import glob
from typing import Dict, List, Optional, Tuple

import numpy as np

from sres_tpu_torch import native
from sres_tpu_torch.config import cfg
from sres_tpu_torch.data.region_loader import RegionTileLoader
from sres_tpu_torch.util.logging import lgm


def mds2d(d: np.ndarray, nx: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """LLC grid → (east, west) hemisphere panels. Tiles 1-6 are the east
    (stacked (3nx, nx) ×2 columns), tiles 8-13 the west ((2nx, 3nx)); tile 7
    (Arctic) is dropped (reference: swot/util.py:9-56)."""
    if nx is None:
        nx = int(round((d.size / 13) ** 0.5))
    assert 13 * nx * nx == d.size, f"size {d.size} is not 13*nx^2"
    east = np.c_[d[: nx * nx * 3].reshape(3 * nx, nx),
                 d[nx * nx * 3: nx * nx * 6].reshape(3 * nx, nx)]
    west = d[nx * nx * 7:].reshape(nx * 2, nx * 3)
    return east, west


def assemble_hemispheres(east: np.ndarray, west: np.ndarray) -> np.ndarray:
    """(3nx, 2nx) east + (2nx, 3nx) west → (3nx, 4nx) global panel
    (reference: swot/raw.py:142)."""
    return np.c_[east, west.T[::-1, :]]


def invert_template(template: str, filename: str) -> Optional[int]:
    """Extract the integer index from a filename given the glob-style template
    with one '*' placeholder (reference used parse: swot/raw.py:128-131)."""
    pat = re.escape(template).replace(r"\*", r"(\d+)")
    m = re.fullmatch(pat, filename)
    return int(m.group(1)) if m else None


class SWOTRawDataLoader(RegionTileLoader):
    def __init__(self, task, **kwargs):
        super().__init__(task, **kwargs)
        self._template_mask: Optional[np.ndarray] = None
        self._scatter_map: Optional[np.ndarray] = None
        self.timers: Dict[str, float] = defaultdict(float)

    # -- path templating (runtime-mutates cfg().dataset like the reference) ----
    def _filepath(self) -> str:
        return f"{cfg().dataset.dataset_root}/{cfg().dataset.dataset_files}"

    def _template_path(self) -> str:
        return f"{cfg().dataset.dataset_root}/{cfg().dataset.template}"

    def get_dset_time_indices(self) -> List[int]:
        cfg().dataset["index"] = "*"
        cfg().dataset["varname"] = list(self.varnames)[0]
        fglob = self._filepath()
        tmpl = fglob.split("/")[-1]
        indices = []
        for fpath in glob(fglob):
            idx = invert_template(tmpl, fpath.split("/")[-1])
            if idx is not None:
                indices.append(idx)
        return sorted(indices)

    def _mask(self) -> np.ndarray:
        if self._template_mask is None:
            self._template_mask = np.fromfile(self._template_path(), ">f4") != 0
        return self._template_mask

    def _subset_roi(self, global_data: np.ndarray) -> np.ndarray:
        roi = cfg().dataset.get("roi", None)
        if roi is None:
            return global_data
        x0, xs = roi.get("x0", 0), roi.get("xs", global_data.shape[-1])
        y0, ys = roi.get("y0", 0), roi.get("ys", global_data.shape[-2])
        return global_data[..., y0:y0 + ys, x0:x0 + xs]

    def load_region(self, varname: str, time_index: int) -> np.ndarray:
        cfg().dataset["varname"] = varname
        cfg().dataset["index"] = time_index
        t0 = time.perf_counter()
        if self._scatter_map is None:
            self._scatter_map = native.build_scatter_map(self._mask())
        t1 = time.perf_counter()
        raw = np.fromfile(self._filepath(), np.uint32)  # big-endian f32 bits
        t2 = time.perf_counter()
        full = native.decode_timestep(raw, self._scatter_map)
        t3 = time.perf_counter()
        global_panel = assemble_hemispheres(*mds2d(full))
        t4 = time.perf_counter()
        region = self._subset_roi(global_panel)
        t5 = time.perf_counter()
        for k, dt in (("map", t1 - t0), ("read", t2 - t1), ("decode", t3 - t2),
                      ("assemble", t4 - t3), ("crop", t5 - t4)):
            self.timers[k] += dt
        lgm().log(f"SWOT load_region({varname},{time_index}): {region.shape}")
        return region
