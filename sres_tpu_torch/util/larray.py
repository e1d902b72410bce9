"""Minimal labeled array (a numpy copy of sres_tpu/util/larray.py:1-91).

The reference threads ``xa.DataArray`` objects with dims
('tiles','channels','y','x'), coords (tile ids, channel names) and attrs
(normalization stats, grid_shape, xyflip) through its data layer
(e.g. sres/base/source/swot/raw.py:233). xarray is not a dependency of this
framework; LArray carries exactly the metadata the pipeline needs while the
payload stays a plain numpy array that becomes a torch tensor at the step
boundary.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


class LArray:
    __slots__ = ("data", "dims", "coords", "attrs")

    def __init__(
        self,
        data: np.ndarray,
        dims: Sequence[str],
        coords: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        assert len(dims) == data.ndim, f"dims {dims} do not match shape {data.shape}"
        self.data = data
        self.dims = tuple(dims)
        self.coords = dict(coords or {})
        self.attrs = dict(attrs or {})

    # -- basic protocol -------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def values(self) -> np.ndarray:
        return self.data

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.dims, self.data.shape))

    def axis(self, dim: str) -> int:
        return self.dims.index(dim)

    def copy(self, data: Optional[np.ndarray] = None) -> "LArray":
        return LArray(
            np.array(self.data) if data is None else data,
            self.dims, dict(self.coords), dict(self.attrs),
        )

    def __repr__(self) -> str:
        return f"LArray{self.dims}{self.shape}"

    # -- selection -------------------------------------------------------------
    def isel(self, **indexers: Union[int, slice, np.ndarray]) -> "LArray":
        """Positional selection along named dims; int indexers drop the dim."""
        idx: List[Any] = [slice(None)] * self.ndim
        dropped = []
        for dim, sl in indexers.items():
            idx[self.axis(dim)] = sl
            if isinstance(sl, int):
                dropped.append(dim)
        new_data = self.data[tuple(idx)]
        new_dims = [d for d in self.dims if d not in dropped]
        new_coords = dict(self.coords)
        for dim, sl in indexers.items():
            if dim in new_coords:
                if isinstance(sl, int):
                    new_coords.pop(dim)
                else:
                    new_coords[dim] = np.asarray(new_coords[dim])[sl]
        return LArray(new_data, new_dims, new_coords, dict(self.attrs))

    def sel(self, **selectors: Any) -> "LArray":
        """Coordinate-label selection (single label → dim dropped)."""
        indexers: Dict[str, Any] = {}
        for dim, label in selectors.items():
            coord = list(np.asarray(self.coords[dim]))
            if isinstance(label, (list, tuple, np.ndarray)):
                indexers[dim] = np.array([coord.index(l) for l in label])
            else:
                indexers[dim] = coord.index(label)
        return self.isel(**indexers)
