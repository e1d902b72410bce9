"""Minimal zarr-v2 directory-store writer, no zarr dependency (a copy of
sres_tpu/util/zarrlite.py:1-83).

Implements just enough of the zarr v2 spec — .zgroup/.zarray/.zattrs JSON
metadata + raw uncompressed C-order chunk files — to export region datasets
that the zarr/xarray ecosystem can open (``zarr.open``/``xr.open_zarr``).
Replaces the reference's ``DataArray.to_zarr(append_dim='time')`` path
(reference: sres/controller/dual_trainer.py:374-394). One chunk per appended
timestep keeps appends O(1).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Sequence, Tuple

import numpy as np

_DTYPE_MAP = {np.dtype(np.float32): "<f4", np.dtype(np.float64): "<f8",
              np.dtype(np.int32): "<i4", np.dtype(np.int64): "<i8"}


class ZarrWriter:
    """Appendable (time, ...) array at ``store/data``."""

    def __init__(self, store: str, item_shape: Tuple[int, ...], dtype,
                 dim_names: Sequence[str] = ()):
        self.store = store
        self.item_shape = tuple(int(s) for s in item_shape)
        self.dtype = np.dtype(dtype)
        self.dim_names = list(dim_names) or ["time"] + [f"dim_{i}" for i in range(len(item_shape))]
        self.nt = 0
        shutil.rmtree(store, ignore_errors=True)
        os.makedirs(f"{store}/data", exist_ok=True)
        with open(f"{store}/.zgroup", "w") as f:
            json.dump({"zarr_format": 2}, f)
        self._write_meta()

    def _write_meta(self) -> None:
        meta = {
            "zarr_format": 2,
            "shape": [self.nt, *self.item_shape],
            "chunks": [1, *self.item_shape],
            "dtype": _DTYPE_MAP[self.dtype],
            "compressor": None,
            "fill_value": "NaN" if self.dtype.kind == "f" else 0,
            "order": "C",
            "filters": None,
        }
        with open(f"{self.store}/data/.zarray", "w") as f:
            json.dump(meta, f)
        with open(f"{self.store}/data/.zattrs", "w") as f:
            json.dump({"_ARRAY_DIMENSIONS": self.dim_names}, f)

    def append(self, block: np.ndarray) -> None:
        """Append (T, *item_shape) along the time axis."""
        block = np.ascontiguousarray(block, self.dtype)
        assert block.shape[1:] == self.item_shape, (block.shape, self.item_shape)
        trailing = ".".join("0" for _ in self.item_shape)
        for t in range(block.shape[0]):
            fname = f"{self.nt + t}.{trailing}" if self.item_shape else str(self.nt + t)
            with open(f"{self.store}/data/{fname}", "wb") as f:
                f.write(block[t].tobytes())
        self.nt += block.shape[0]
        self._write_meta()

    def close(self) -> None:
        self._write_meta()


def read_zarr(store: str) -> np.ndarray:
    """Read back a ZarrWriter store (test helper / lightweight consumer)."""
    with open(f"{store}/data/.zarray") as f:
        meta = json.load(f)
    shape, chunks, dtype = meta["shape"], meta["chunks"], np.dtype(meta["dtype"])
    assert chunks[0] == 1 and chunks[1:] == shape[1:], "only ZarrWriter layout supported"
    out = np.empty(shape, dtype)
    trailing = ".".join("0" for _ in shape[1:])
    for t in range(shape[0]):
        fname = f"{t}.{trailing}" if shape[1:] else str(t)
        with open(f"{store}/data/{fname}", "rb") as f:
            out[t] = np.frombuffer(f.read(), dtype).reshape(shape[1:])
    return out
