"""Inference artifact IO (counterpart of sres_tpu/data/inference_io.py;
reference: sres/data/inference.py).

Saves per-variable {input,target,interpolated,model} images plus losses to
NetCDF at the same path scheme the reference uses
(``{results}/inference/{dataset}/{task}/{var}-{t}.{tiles|image}[_ds-x.xx].nc``)
so the reference's result-browser notebooks find the files. Written as
NetCDF3-classic via scipy (xarray-readable); the LR input keeps separate
ys/xs dims to coexist with the HR dims, exactly like the reference (:25,49).
"""
from __future__ import annotations

import glob as _glob
import os
from enum import Enum
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
from scipy.io import netcdf_file

from sres_tpu_torch.config import cfg, config
from sres_tpu_torch.util.larray import LArray


class ResultStructure(Enum):
    Tiles = "tiles"
    Image = "image"


class TSet(Enum):
    Train = "train"
    Validation = "valid"
    Test = "test"
    Upsample = "upsample"


class srRes(Enum):
    """Resolution tags (reference: sres/controller/config.py:13-22); kept for
    API compatibility — this framework always synthesizes LR on device."""
    Low = "lr"
    High = "hr"
    Raw = "raw"

    @classmethod
    def from_config(cls, sval: str) -> "srRes":
        return {"low": cls.Low, "high": cls.High, "raw": cls.Raw}[sval]


def results_path(varname: str, timestep, data_structure: ResultStructure, remove: bool = False) -> str:
    dsf = float(cfg().task.get("data_downsample", 1.0))
    dss = "" if dsf == 1.0 else f"_ds-{dsf:.2f}"
    path = (f"{cfg().platform.results}/inference/{config()['dataset']}/{config()['task']}"
            f"/{varname}-{timestep}.{data_structure.value}{dss}.nc")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if remove and os.path.exists(path):
        os.remove(path)
    return path


def time_indices(varname: str, data_structure: ResultStructure) -> List[int]:
    gpath = results_path(varname, "*", data_structure)
    return [int(Path(fn).stem.split(".")[0].split("-")[1]) for fn in _glob.glob(gpath)]


def save_inference_results(varname: str, data_structure: ResultStructure,
                           var_results: Dict[str, LArray], timestep,
                           var_losses: Dict[str, float]) -> str:
    rpath = results_path(varname, timestep, data_structure, remove=True)
    f = netcdf_file(rpath, "w")
    f.loss_keys = ",".join(var_losses.keys())
    f.loss_values = np.array(list(var_losses.values()), np.float64)
    made_dims: Dict[str, int] = {}
    for rtype, arr in var_results.items():
        # the LR input gets its own ys/xs dims (reference: inference.py:25)
        dims = tuple(("ys" if d == "y" else "xs" if d == "x" else d) for d in arr.dims) \
            if rtype == "input" else arr.dims
        final_dims = []
        for d, n in zip(dims, arr.shape):
            # under fractional data_downsample model/target spatial sizes can
            # differ — allocate size-suffixed dims on conflict
            name = d if made_dims.get(d, n) == n else f"{d}{n}"
            if name not in made_dims:
                f.createDimension(name, n)
                made_dims[name] = n
            final_dims.append(name)
        v = f.createVariable(rtype, "f4", tuple(final_dims))
        v[:] = np.asarray(arr.data, np.float32)
    f.close()
    return rpath


def load_inference_results(varname: str, data_structure: ResultStructure,
                           timestep) -> Tuple[Dict[str, LArray], Dict[str, float]]:
    rpath = results_path(varname, timestep, data_structure)
    f = netcdf_file(rpath, "r", mmap=False)
    keys = f.loss_keys.decode() if isinstance(f.loss_keys, bytes) else f.loss_keys
    # a single value reads back as a scalar
    losses = dict(zip(keys.split(","),
                      np.atleast_1d(np.asarray(f.loss_values, np.float64)).tolist()))
    results: Dict[str, LArray] = {}
    for name, var in f.variables.items():
        dims = tuple(("y" if d == "ys" else "x" if d == "xs" else d) for d in var.dimensions)
        results[name] = LArray(np.array(var[:], np.float32), dims)
    f.close()
    return results, losses
