"""WorkflowController — the public API layer (counterpart of
sres_tpu/controller/workflow.py:21-165; reference sres/controller/workflow.py):
train a list of models, each in its own config context, and serve them:
tile- and image-structured inference with the NetCDF artifacts, over the
region modes ``tiled``, ``seamless`` and ``spatial``, and pipelined over
timesteps (``inference_stream``). The zarr export and the result views
wait for ROADMAP Queue 1 items 5 and 7.

Unlike the JAX controller, a failure in training is not caught and logged:
it propagates, so a kernel or build fault stops the run.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from sres_tpu_torch.config import ConfigContext, cfg
from sres_tpu_torch.data.inference_io import (ResultStructure, TSet,
                                              save_inference_results)
from sres_tpu_torch.trainer.trainer import ModelTrainer
from sres_tpu_torch.util.larray import LArray
from sres_tpu_torch.util.logging import LogManager, lgm


class WorkflowController:
    def __init__(self, cname: str, configuration: Dict[str, Any], **kwargs):
        self.cname = cname
        self.seed = kwargs.get("seed", int(time.time() / 60))
        self.interp_loss = kwargs.get("interp_loss", False)
        self.refresh_state = bool(kwargs.get("refresh_state", False))
        # the command line that -r / -ne are read from (default: this process's)
        self.argv: Optional[Sequence[str]] = kwargs.get("argv")
        self.config: Optional[ConfigContext] = None
        self.trainer: Optional[ModelTrainer] = None
        self.model: Optional[str] = None
        ConfigContext.set_defaults(**configuration)

    def train(self, models: List[str], **kwargs) -> None:
        for model in models:
            with ConfigContext(self.cname, model=model, **kwargs) as cc:
                self.config = cc
                LogManager.reset()
                args = self.get_args()
                self.trainer = ModelTrainer(cc, seed=self.seed)
                self.trainer.train(args.nepochs, args.refresh or self.refresh_state,
                                   seed=self.seed, interp_loss=self.interp_loss)
                lgm().log(f"Completed training model: {model}", display=True)

    def get_args(self) -> argparse.Namespace:
        """-r/--refresh and -ne/--nepochs (reference: workflow.py:44-48);
        other arguments are ignored."""
        p = argparse.ArgumentParser(description=f"Execute workflow {self.cname}",
                                    allow_abbrev=False)
        p.add_argument("-r", "--refresh", action="store_true",
                       help="delete existing checkpoints and loss history")
        p.add_argument("-ne", "--nepochs", nargs="?", default=cfg().task.nepochs, type=int,
                       help="number of training epochs")
        argv = sys.argv[1:] if self.argv is None else list(self.argv)
        args, _ = p.parse_known_args(argv)
        return args

    # -------------------------------------------------------------- inference
    def inference(self, timestep: int, data_structure: ResultStructure, **kwargs
                  ) -> Tuple[Dict[str, Dict[str, LArray]], Dict[str, Dict[str, float]]]:
        """One timestep served from the best-validation checkpoint: tiles of
        the validation set (``Tiles``), or the region image (``Image``) by
        ``region_mode``: ``tiled`` (``process_image``), ``seamless`` or
        ``spatial``; each variable's panels saved as NetCDF unless
        ``save=False``. The time the writes take adds to the trainer's
        ``timers['netcdf_write']``."""
        varnames = self.trainer.target_variables
        region_mode = kwargs.pop("region_mode", "tiled")
        if region_mode not in ("tiled", "seamless", "spatial"):
            raise ValueError(
                f"Unknown region_mode {region_mode!r}: expected one of "
                "'tiled', 'seamless', 'spatial'")
        if data_structure == ResultStructure.Image and region_mode != "tiled":
            ctime = self.trainer.get_dset_time_indices()[timestep]
            fn = {"seamless": self.trainer.infer_region_seamless,
                  "spatial": self.trainer.infer_region_spatial}[region_mode]
            image_results = fn(ctime, update_model=kwargs.get("update_model", True))
            eval_results = {vn: {} for vn in varnames}
        elif data_structure == ResultStructure.Image:
            kwargs.setdefault("update_model", True)
            image_results, eval_results = self.trainer.process_image(
                TSet.Validation, timestep, interp_loss=True, **kwargs)
        elif data_structure == ResultStructure.Tiles:
            # served tiles are not augmented: evaluate() reads the task's
            # xyflip, which JAX leaves on here (synthetic-tiles-48: true);
            # process_image turns it off the same way
            cfg().task["xyflip"] = False
            kwargs.setdefault("update_model", True)
            image_results, eval_results = {}, {}
            condensed, losses = self.trainer.evaluate(
                TSet.Validation, time_index=timestep, update_checkpoint=False, **kwargs)
            if len(varnames) == 1:
                image_results = {varnames[0]: {k: v.isel(channels=0)
                                               for k, v in condensed.items() if v is not None}}
                eval_results = {varnames[0]: losses}
            else:
                for vn in varnames:
                    image_results[vn] = {
                        k: (v.sel(channels=vn) if vn in list(v.coords.get("channels", [])) else v)
                        for k, v in condensed.items() if v is not None}
                    eval_results[vn] = losses
        else:
            raise ValueError(f"Unknown result structure: {data_structure}")
        if kwargs.get("save", True):
            self._save(data_structure, timestep, image_results, eval_results)
        return image_results, eval_results

    def _save(self, data_structure: ResultStructure, timestep: int,
              image_results: Dict[str, Dict[str, LArray]],
              eval_results: Dict[str, Dict[str, float]]) -> None:
        t0 = time.perf_counter()
        for vn in self.trainer.target_variables:
            if vn in image_results and image_results[vn]:
                save_inference_results(vn, data_structure, image_results[vn],
                                       timestep, eval_results.get(vn, {}))
        self.trainer.timers["netcdf_write"] += time.perf_counter() - t0

    def inference_stream(self, timesteps, save: bool = True, prefetch: int = 2,
                         **kwargs):
        """Pipelined multi-timestep image inference: yields ``(timestep,
        image_results)`` and saves the per-timestep NetCDF artifacts of
        ``inference(t, ResultStructure.Image)`` (with no eval losses:
        computing them would re-enter the per-tile eval path per timestep).
        Runs ``ModelTrainer.infer_region_stream``: the host prep of
        timestep t+1 overlaps the card's work on t (``prefetch=0``: no prep
        thread). Loads the best-validation checkpoint unless
        ``update_model=False``."""
        kwargs.setdefault("update_model", True)
        tindices = self.trainer.get_dset_time_indices()
        timesteps = list(timesteps)
        ctimes = [tindices[t] for t in timesteps]
        stream = self.trainer.infer_region_stream(ctimes, prefetch=prefetch, **kwargs)
        for ts, (_, image_results) in zip(timesteps, stream):
            if save:
                self._save(ResultStructure.Image, ts, image_results, {})
            yield ts, image_results

    # ---------------------------------------------------------------- plumbing
    def initialize(self, cname: str, model: str, **kwargs) -> None:
        self.model = model
        self.config = ConfigContext.activate_global(cname, model=model, **kwargs)
        LogManager.reset()
        lgm().log(f"Initialize WorkflowController({cname}), model={model}")
        self.trainer = ModelTrainer(self.config, seed=self.seed)

    def init_context(self, cc: ConfigContext, model: str) -> None:
        self.model = model
        self.config = cc
        self.trainer = ModelTrainer(cc, seed=self.seed)

    def test(self, model: str, test_name: str, **kwargs) -> None:
        with ConfigContext(self.cname, model=model, **kwargs) as cc:
            self.config = cc
            self.trainer = ModelTrainer(cc, seed=self.seed)
            if test_name == "load_raw_dataset":
                times = self.trainer.get_dset_time_indices()
                self.trainer.dataset.load_timeslice(times[0])
