"""ModelTrainer — the training and evaluation engine (counterpart of
sres_tpu/trainer/trainer.py:46-591; reference sres/controller/dual_trainer.py).

Epochs → timeslices → tile batches, checkpoint and resume, the loss CSV and
the best-validation roll stay in Python; every batch's work (LR synthesis,
forward, loss, backward, optimizer update, bicubic baseline) is one call of
a step from ``trainer/step.py`` on the card. Batches reach the card from
pinned host memory without a wait, metrics stay on the card, and the host
reads them once a timeslice, so the host can queue steps ahead of the card.

Ragged batches (NaN-filtered tile counts vary per timeslice) are padded to
the batch size with 0-weight tiles. One process drives one device: the JAX
trainer's mesh, its multi-host seeding and ``pipeline.shard_map`` have no
counterpart here, and ``pipeline.profile``, ``packed_opt``, ``mesh``,
``shard_map`` and ``memory_debug`` are accepted with no effect; ``to_zarr``
waits for ROADMAP Queue 1 item 5.

Serving (counterpart of sres_tpu/trainer/trainer.py:592-1064):
``process_image`` runs a timeslice's tile batches through the eval step and
assembles them on the host; ``infer_region`` runs every grid slot of a
timeslice as one padded batch on the card and assembles the mosaic there
(``ops/assemble.py``), and ``infer_region_stream`` pipelines it over
timeslices; ``infer_region_seamless`` runs haloed tiles, and
``infer_region_spatial`` the whole active region as one image. Every mode
denormalizes each target panel with its own variable's stats.

``timers`` holds the host's seconds by part (``load``: a timeslice's
region → tiles, or the wait for its prefetch; ``assemble``: tile
selection, normalization and flips; ``pad``; ``to_device``; ``dispatch``:
queuing the steps; ``metrics_to_host``; ``train``: the timeslices' walls;
``valid``, ``test``; serving: ``region_prep``, the host prep of a region
timeslice, on the prefetch thread when streamed; ``region_to_device``;
``region_dispatch``, queuing the region step; ``region_to_host``, the wait
for its images and their copy; ``checkpoint_load``, reading the
best-validation checkpoint) and counts: ``steps``, the train batches
run; ``pad_batches``, the zero-weight micro-batches of accumulation tails;
``eval_steps``; ``regions``.
"""
from __future__ import annotations

import math
import random
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from sres_tpu_torch.config import ConfigContext, cfg, trainer_device
from sres_tpu_torch.data.batch import BatchDataset
from sres_tpu_torch.data.inference_io import TSet
from sres_tpu_torch.data.input_pipeline import iter_pipelined
from sres_tpu_torch.data.norm import (denorm, normalize_batch, normalize_with_attrs,
                                      slice_stats, tile_stats_maps)
from sres_tpu_torch.data.overlap import extract_overlapped_tiles
from sres_tpu_torch.data.tiles import TileIterator, batchDomain
from sres_tpu_torch.device import resolve_device
from sres_tpu_torch.models import build_model
from sres_tpu_torch.ops.assemble import assemble_tiles
from sres_tpu_torch.ops.resize import downsample, upsample
from sres_tpu_torch.parallel.spatial import infer_region_sharded
from sres_tpu_torch.trainer.checkpoints import CheckpointManager
from sres_tpu_torch.trainer.losses import psnr
from sres_tpu_torch.trainer.results import ResultsAccumulator
from sres_tpu_torch.trainer.step import (build_accum_train_step, build_eval_step,
                                         build_multi_train_step, build_optimizer,
                                         build_train_step, interp_baseline,
                                         lr_at_epoch, make_step_config,
                                         prepare_inputs, set_learning_rate)
from sres_tpu_torch.util.larray import LArray
from sres_tpu_torch.util.logging import lgm

TimeType = Any


def ttsplit_times(times: List[TimeType]) -> Dict[TSet, List[TimeType]]:
    """Contiguous train/valid/test split by the task fractions
    (reference: dual_trainer.py:28-36)."""
    ttsplit = cfg().task.ttsplit
    start, result, nt = 0, {}, len(times)
    for tset_name, frac in ttsplit.items():
        end = start + int(float(frac) * nt)
        result[TSet(tset_name)] = times[start:end]
        start = end
    return result


class ModelTrainer:
    def __init__(self, cc: ConfigContext, seed: int = 4456):
        self.context = cc
        self.results_accum = ResultsAccumulator(cc)
        self.domain = batchDomain.from_config(cfg().task.get("batch_domain", "tiles"))
        self.target_variables: List[str] = list(cfg().task.target_variables)
        self.input_variables: List[str] = list(cfg().task.input_variables)
        self.downscale_factors = list(cfg().model.downscale_factors)
        self.scale_factor = math.prod(self.downscale_factors)
        self.model_name: str = cfg().model.name
        self.device = resolve_device(trainer_device(cfg().pipeline))
        if str(cfg().task.batch_size) == "auto":
            raise NotImplementedError("task.batch_size: auto is not ported yet "
                                      "(ROADMAP Queue 1 item 7)")
        self.batch_size: int = int(cfg().task.batch_size)
        self.pad_size: int = self.batch_size

        self.conform_to_data_grid()
        self.dataset = BatchDataset(cfg().task, seed=seed)
        task, model_cfg = cfg().task.to_dict(), cfg().model.to_dict()
        precision = cfg().pipeline.get("precision", "bf16")
        self.model = build_model(model_cfg, len(self.input_variables),
                                 len(self.target_variables), precision=precision,
                                 seed=seed, device=str(self.device))
        self.optimizer = build_optimizer(self.model, task,
                                         packed=bool(cfg().pipeline.get("packed_opt", False)))
        self.step_config = make_step_config(task, model_cfg)
        self._train_step = build_train_step(self.model, self.optimizer, self.step_config)
        self._eval_step = build_eval_step(self.model, self.step_config)
        # K > 1: K staged padded batches a call, K optimizer steps
        # (steps_per_dispatch) or one update (grad_accum); exclusive
        self.steps_per_dispatch = max(1, int(cfg().pipeline.get("steps_per_dispatch", 1)))
        self.grad_accum = max(1, int(cfg().pipeline.get("grad_accum", 1)))
        assert self.steps_per_dispatch == 1 or self.grad_accum == 1, \
            "pipeline.steps_per_dispatch and pipeline.grad_accum are exclusive"
        if self.grad_accum > 1:
            self.steps_per_dispatch = self.grad_accum
            self._multi_step = build_accum_train_step(self.model, self.optimizer,
                                                      self.step_config)
        else:
            self._multi_step = (build_multi_train_step(self.model, self.optimizer,
                                                       self.step_config)
                                if self.steps_per_dispatch > 1 else None)

        self.checkpoint_manager = CheckpointManager(self.model, self.optimizer)
        # batch-shuffle rng: seeded, not the global random module
        self._shuffle_rng = random.Random(seed)
        # serializes the loader's current-timeslice state between callers
        self.loader_lock = threading.RLock()
        self._prefetch = (ThreadPoolExecutor(1, thread_name_prefix="timeslice-prefetch")
                          if bool(cfg().pipeline.get("prefetch", True)) else None)
        self.input_backend = str(cfg().pipeline.get("input_backend", "sync"))
        self.input_depth = int(cfg().pipeline.get("input_depth", 2))
        self.input_workers = int(cfg().pipeline.get("num_workers", 1))
        self.data_timestamps: Dict[TSet, List[TimeType]] = {}
        self.validation_loss = float("inf")
        self.time_index: int = -1
        self.tile_index: int = -1
        self.current_losses: Dict[str, float] = {}
        self.timers: Dict[str, float] = defaultdict(float)
        # the side stream of the region images' copies to the host
        self._d2h_stream: Optional[torch.cuda.Stream] = None
        # merged eval result tensors per tset (reference: dual_trainer.py:136-139)
        self.input: Dict[TSet, Optional[np.ndarray]] = {}
        self.target: Dict[TSet, Optional[np.ndarray]] = {}
        self.product: Dict[TSet, Optional[np.ndarray]] = {}
        self.interp: Dict[TSet, Optional[np.ndarray]] = {}

    # ------------------------------------------------------------- utilities
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the trainer's device; to the card through pinned
        memory, queued without waiting for the card's work."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _timed_call(self, step, *arrays):
        t0 = time.perf_counter()
        inputs = [self._to_device(a) for a in arrays]
        t1 = time.perf_counter()
        out = step(*inputs)
        self.timers["to_device"] += t1 - t0
        self.timers["dispatch"] += time.perf_counter() - t1
        return out

    def _run_train_step(self, hr: np.ndarray, weight: np.ndarray):
        return self._timed_call(self._train_step, hr, weight)

    def _run_multi_step(self, staged):
        """One call over K staged (hr, weight) padded batches; (K,) metrics."""
        return self._timed_call(self._multi_step, np.stack([s[0] for s in staged]),
                                np.stack([s[1] for s in staged]))

    def _run_eval_step(self, hr: np.ndarray, weight: np.ndarray):
        self.timers["eval_steps"] += 1
        return self._eval_step(self._to_device(hr), self._to_device(weight))

    @property
    def nparams(self) -> int:
        return sum(p.numel() for p in self.model.parameters())

    def conform_to_data_grid(self) -> None:
        """Snap task.origin onto the tile grid when task.conform_to_grid is
        set (reference: dual_trainer.py:179-187)."""
        if not cfg().task.get("conform_to_grid", False):
            return
        ts = cfg().task.tile_size
        origin = dict(cfg().task.get("origin", {}) or {})
        snapped = {d: int(round(origin.get(d, 0) / (ts[d] * self.scale_factor)))
                   * ts[d] * self.scale_factor for d in ("x", "y")}
        if snapped != origin:
            lgm().log(f" ** snap_origin_to_data_grid: {origin} -> {snapped}", display=True)
        cfg().task["origin"] = snapped

    def init_data_timestamps(self) -> None:
        if not self.data_timestamps:
            ctimes = self.dataset.get_batch_time_coords()
            self.data_timestamps = ttsplit_times(ctimes)
            lgm().log(f"init_data_timestamps: {len(ctimes)} times", display=True)

    def _pad_batch(self, batch: LArray) -> Tuple[np.ndarray, np.ndarray, int]:
        """(B,C,H,W) LArray → fixed-size padded arrays + valid count."""
        data = batch.data
        nvalid = data.shape[0]
        if nvalid < self.pad_size:
            pad = np.zeros((self.pad_size - nvalid,) + data.shape[1:], data.dtype)
            data = np.concatenate([data, pad], axis=0)
        weight = np.zeros((self.pad_size,), np.float32)
        weight[:nvalid] = 1.0
        return data, weight, nvalid

    def _metrics_to_host(self, metrics_list: List[Dict[str, torch.Tensor]]
                         ) -> Dict[str, np.ndarray]:
        """One read of the card: the metrics of a timeslice's calls (0-d per
        step, (K,) per staged call) → host arrays by key."""
        if not metrics_list:
            return {}
        t0 = time.perf_counter()
        keys = list(metrics_list[0])
        flat = torch.cat([m[k].reshape(-1).float() for k in keys for m in metrics_list])
        host = flat.cpu().numpy()
        sizes = [sum(m[k].numel() for m in metrics_list) for k in keys]
        out, at = {}, 0
        for k, n in zip(keys, sizes):
            out[k] = host[at:at + n]
            at += n
        self.timers["metrics_to_host"] += time.perf_counter() - t0
        return out

    # ------------------------------------------------------------------ train
    def train(self, nepochs: int, refresh_state: bool = False, **kwargs) -> Dict[str, float]:
        """Train ``nepochs`` epochs, resuming from the train checkpoint
        unless ``refresh_state`` (reference semantics, dual_trainer.py:
        290-293: ``nepochs += epoch0`` on every run that is not refreshed,
        and a resumed run starts at the checkpoint's epoch and timeslice).
        ``interp_loss`` is accepted; the baseline is always computed."""
        if nepochs == 0:
            return {}
        seed = kwargs.get("seed", 4456)
        self.dataset.reseed(seed)
        self._shuffle_rng = random.Random(seed)
        ckpt_period = int(cfg().pipeline.get("checkpoint_period", 1))
        epoch0, itime0, epoch_loss = 1, 0, 0.0
        train_start = time.time()

        if refresh_state:
            self.checkpoint_manager.clear_checkpoints()
            self.results_accum.refresh_state()
            lgm().log(" *** No checkpoint loaded: training from scratch *** ", display=True)
        else:
            meta = self.checkpoint_manager.load_checkpoint(TSet.Train, update_model=True)
            if meta:
                self.results_accum.load_results()
                epoch0 = meta.get("epoch", 1)
                itime0 = meta.get("itime", 0)
                epoch_loss = meta.get("loss", float("inf"))
            nepochs += epoch0

        self.init_data_timestamps()
        interp_epoch_loss = 0.0
        for epoch in range(epoch0, nepochs):
            epoch_start = time.time()
            if cfg().task.get("scheduler", None):
                # per-epoch scheduler step (reference: dual_trainer.py:333-334)
                set_learning_rate(self.optimizer, lr_at_epoch(cfg().task.to_dict(), epoch - 1))
            train_times = self.data_timestamps[TSet.Train]
            nts = len(train_times)
            lgm().log(f" ----- Epoch {epoch}/{nepochs} nts={nts} ----- ", display=True)
            for itime in range(itime0, nts):
                ctime = train_times[itime]
                t0 = time.perf_counter()
                metrics_list = self._train_timeslice(train_times, itime)
                m = self._metrics_to_host(metrics_list)
                self.timers["train"] += time.perf_counter() - t0
                if len(m.get("sloss", ())) == 0:
                    continue
                epoch_loss = float(np.mean(m["sloss"]))
                interp_epoch_loss = float(np.mean(m["interp_sloss"]))
                ratio = 100.0 * epoch_loss / max(interp_epoch_loss, 1e-12)
                lgm().log(
                    f" ** <{self.model_name}> TRAIN E({epoch:3}/{nepochs}) TIME[{itime:3}:{ctime}] "
                    f"-> Loss= {epoch_loss*1000:6.2f} ({interp_epoch_loss*1000:6.2f}): {ratio:.2f}%",
                    display=True)
                if (itime + 1) % ckpt_period == 0 or itime == nts - 1:
                    self.checkpoint_manager.save_checkpoint(
                        epoch, itime, TSet.Train, epoch_loss, interp_epoch_loss)
                self.results_accum.record_losses(
                    TSet.Train, epoch - 1 + itime / max(nts, 1), epoch_loss,
                    interp_epoch_loss, flush=((itime + 1) % 32 == 0))

            epoch_time = (time.time() - epoch_start) / 60.0
            lgm().log(f"Epoch Execution time: {epoch_time:.1f} min, train-loss: {epoch_loss:.4f}",
                      display=True)
            self.record_eval(epoch, {TSet.Train: epoch_loss}, TSet.Validation)
            itime0 = 0

        train_time = time.time() - train_start
        self.record_eval(nepochs, {}, TSet.Test)
        self.results_accum.flush()
        self.checkpoint_manager.flush()
        lgm().log(f" -------> Training model with {self.nparams} wts took {train_time/60:.2f} min",
                  display=True)
        self.current_losses = dict(prediction=epoch_loss)
        return self.current_losses

    def _train_timeslice(self, train_times: List[TimeType], itime: int
                         ) -> List[Dict[str, torch.Tensor]]:
        """One timeslice's batches through the step (or the staged steps);
        returns their metrics, still on the device."""
        ctime = train_times[itime]
        metrics_list: List[Dict[str, torch.Tensor]] = []
        # loader_lock held for the whole timeslice: load_timeslice sets the
        # loader's current slice and every select_batch below reads it; the
        # input-pipeline thread belongs to this critical section
        with self.loader_lock:
            t0 = time.perf_counter()
            tile_iter = self._tile_iterator(ctime, randomize=True)
            self.timers["load"] += time.perf_counter() - t0
            self._prefetch_next(train_times, itime)
            staged = []
            batch_stream = iter_pipelined(
                self._make_batch_producer(ctime), iter(tile_iter),
                self.input_backend, self.input_depth, self.input_workers)
            for hr, weight, nvalid in batch_stream:
                self.timers["steps"] += 1
                if self.steps_per_dispatch == 1:
                    metrics_list.append(self._run_train_step(hr, weight))
                else:
                    staged.append((hr, weight))
                    if len(staged) == self.steps_per_dispatch:
                        metrics_list.append(self._run_multi_step(staged))
                        staged = []
            if staged and self.grad_accum > 1:
                # ragged tail under accumulation: pad to K with zero-weight
                # micro-batches (inert in build_accum_train_step), so one
                # update still takes up to K batches
                nreal = len(staged)
                self.timers["pad_batches"] += self.steps_per_dispatch - nreal
                hr0, w0 = staged[0]
                staged += [(np.zeros_like(hr0), np.zeros_like(w0))] * \
                          (self.steps_per_dispatch - nreal)
                metrics = self._run_multi_step(staged)
                metrics_list.append({k: v[:nreal] for k, v in metrics.items()})
            else:
                # ragged tail of multi-step staging: per-batch steps are the
                # same updates
                for hr, weight in staged:
                    metrics_list.append(self._run_train_step(hr, weight))
        return metrics_list

    def _make_batch_producer(self, ctime: TimeType):
        """ctile → padded (hr, weight, nvalid), or None at the end of the
        data; in grain mode the xyflip index comes from a per-tile seed."""
        grain_mode = self.input_backend == "grain"

        def produce(ctile):
            t0 = time.perf_counter()
            flip_index = (self.dataset.flip_index_for(ctime, ctile)
                          if grain_mode else None)
            batch = self.dataset.get_batch_array(ctile, ctime, flip_index=flip_index)
            t1 = time.perf_counter()
            out = None if batch is None else self._pad_batch(batch)
            self.timers["assemble"] += t1 - t0
            self.timers["pad"] += time.perf_counter() - t1
            return out

        return produce

    def _tile_iterator(self, ctime: TimeType, randomize: bool = False) -> TileIterator:
        if self.domain == batchDomain.Tiles:
            timeslice = self.dataset.load_timeslice(ctime)
            return TileIterator.get_iterator(ntiles=timeslice.sizes["tiles"],
                                             randomize=randomize, rng=self._shuffle_rng)
        return TileIterator.get_iterator(randomize=randomize, rng=self._shuffle_rng)

    def _prefetch_next(self, times: List[TimeType], itime: int) -> None:
        """Warm the next timeslice on a worker thread."""
        if self._prefetch is None or itime + 1 >= len(times):
            return
        loader = self.dataset.srbatch.data_loader
        if hasattr(loader, "prefetch_timeslice"):
            self._prefetch.submit(loader.prefetch_timeslice, times[itime + 1])

    def record_eval(self, epoch: int, losses: Dict[TSet, float], tset: TSet, **kwargs):
        if float(cfg().task.ttsplit.get(tset.value, 0.0)) > 0.0:
            t0 = time.perf_counter()
            _, eval_losses = self.evaluate(tset, update_model=False, **kwargs)
            self.timers[tset.value] += time.perf_counter() - t0
            if eval_losses:
                self.results_accum.record_losses(
                    tset, epoch, eval_losses["model"], eval_losses["interpolated"])
                self.results_accum.flush()
            return eval_losses

    # ---------------------------------------------------------------- evaluate
    def evaluate(self, tset: TSet, **kwargs) -> Tuple[Dict[str, LArray], Dict[str, float]]:
        """Eval over a tset's timeslices; merges per-batch result tensors and
        rolls the best-validation checkpoint (reference: dual_trainer.py:482)."""
        assert tset in (TSet.Validation, TSet.Test), f"Invalid eval tset: {tset.name}"
        self.time_index = kwargs.get("time_index", self.time_index)
        self.tile_index = kwargs.get("tile_index", self.tile_index)
        update_checkpoint = kwargs.get("update_checkpoint", True)
        update_model = kwargs.get("update_model", False)
        epoch = 0
        if update_model or update_checkpoint:
            meta = self._load_best(update_model)
            if meta is None:
                lgm().log("Error loading checkpoint file, skipping evaluation.", display=True)
                return {}, {}
            if meta:
                self.validation_loss = meta.get("loss", float("inf"))
                epoch = meta.get("epoch", 0)
        self.init_data_timestamps()

        self.clear_results(tset)
        model_losses, interp_losses = [], []
        with self.loader_lock:
            for itime, ctime in enumerate(self.data_timestamps.get(tset, [])):
                if self.time_index >= 0 and itime != self.time_index:
                    continue
                tile_iter = self._tile_iterator(ctime)
                for itile, ctile in enumerate(iter(tile_iter)):
                    if not self._tile_in_batch(itile, ctile):
                        continue
                    batch = self.dataset.get_batch_array(ctile, ctime)
                    if batch is None:
                        break
                    hr, weight, nvalid = self._pad_batch(batch)
                    metrics, outputs = self._run_eval_step(hr, weight)
                    model_losses.append(float(metrics["sloss"]))
                    interp_losses.append(float(metrics["interp_sloss"]))
                    self._merge_results(tset, outputs, nvalid)
                    if self.tile_index >= 0:
                        break
                if self.time_index >= 0:
                    break

        if not model_losses:
            return {}, {}
        model_loss = float(np.mean(model_losses))
        interp_loss = float(np.mean(interp_losses))
        if tset == TSet.Validation and update_checkpoint:
            if model_loss < self.validation_loss or self.validation_loss == 0.0:
                self.checkpoint_manager.save_checkpoint(
                    epoch, 0, TSet.Validation, model_loss, interp_loss)
                self.validation_loss = model_loss
        tgt = self.target.get(tset)
        drange = float(np.nanmax(tgt) - np.nanmin(tgt)) if tgt is not None else 1.0
        losses = dict(model=model_loss, interpolated=interp_loss,
                      model_psnr=float(psnr(model_loss, drange)),
                      interpolated_psnr=float(psnr(interp_loss, drange)))
        results = {k: self._to_xa(getattr(self, k)[tset], upscaled=(k == "input"))
                   for k in ("input", "target", "product", "interp")}
        results = dict(input=results["input"], target=results["target"],
                       model=results["product"], interpolated=results["interp"])
        lgm().log(f" -------> Eval {tset.value}: model loss={model_loss:.4f} "
                  f"interp={interp_loss:.4f}", display=True)
        return results, losses

    def _tile_in_batch(self, itile: int, ctile) -> bool:
        if self.tile_index < 0:
            return True
        if self.domain == batchDomain.Time:
            return self.tile_index == itile
        return ctile["start"] <= self.tile_index < ctile["end"]

    def clear_results(self, tset: TSet) -> None:
        for d in (self.input, self.target, self.product, self.interp):
            d[tset] = None

    def _merge_results(self, tset: TSet, outputs, nvalid: int) -> None:
        lr, out, tar, interp = [o[:nvalid].cpu().numpy() for o in outputs]
        for store, arr in ((self.input, lr), (self.target, tar),
                           (self.product, out), (self.interp, interp)):
            prev = store.get(tset)
            store[tset] = arr if prev is None else np.concatenate([prev, arr], axis=0)

    def _to_xa(self, data: Optional[np.ndarray], upscaled: bool = False) -> Optional[LArray]:
        if data is None:
            return None
        cscale = self.scale_factor if upscaled else 1
        coords = dict(tiles=np.arange(data.shape[0]), channels=self.target_variables
                      if data.shape[1] == len(self.target_variables) else self.input_variables)
        coords["y"] = np.arange(0, data.shape[2] * cscale, cscale)
        coords["x"] = np.arange(0, data.shape[3] * cscale, cscale)
        return LArray(data.astype(np.float32), ["tiles", "channels", "y", "x"], coords)

    def get_dset_time_indices(self) -> List[TimeType]:
        return self.dataset.get_dset_time_indices()

    # ------------------------------------------------------------ process_image
    def process_image(self, tset: TSet, itime: int, **kwargs
                      ) -> Tuple[Dict[str, Dict[str, LArray]], Dict[str, Dict[str, float]]]:
        """Full-timeslice inference + denorm + region re-assembly on the host
        (reference: dual_trainer.py:396-447). As in JAX, ``itime`` indexes
        the train timestamps whatever ``tset`` is. Unlike JAX
        (sres_tpu/trainer/trainer.py:627-634), the target, model and
        interpolated panels are denormalized with their own variables'
        stats, so target ⊂ input gives the target's values."""
        cfg().task["xyflip"] = False
        update_model = kwargs.get("update_model", True)
        meta = self._load_best(update_model)
        if meta is None:
            lgm().log("Error loading checkpoint file, skipping evaluation.", display=True)
            return {}, {}
        self.init_data_timestamps()
        ctime = self.data_timestamps[TSet.Train][itime]
        cvar = kwargs.get("var", None)
        output_vars = [cvar] if cvar is not None else self.target_variables
        tidx = list(self.step_config.target_idx)

        batches, metrics_list = [], []
        # loader_lock: serialize with a live infer_region_stream prefetch
        # worker (shared stateful loader)
        with self.loader_lock:
            timeslice = self.dataset.load_timeslice(ctime)
            tile_iter = self._tile_iterator(ctime)
            for ctile in iter(tile_iter):
                batch = self.dataset.get_batch_array(ctile, ctime)
                if batch is None:
                    break
                hr, weight, nvalid = self._pad_batch(batch)
                metrics, outputs = self._run_eval_step(hr, weight)
                metrics_list.append(metrics)
                lr, out, tar, interp = self._to_host(*[o[:nvalid] for o in outputs])
                stats = _stats(batch.attrs)
                tstats = slice_stats(stats, tidx)
                batches.append(dict(input=denorm(lr, stats), target=denorm(tar, tstats),
                                    interpolated=denorm(interp, tstats),
                                    model=denorm(out, tstats)))

        m = self._metrics_to_host(metrics_list)
        images, losses = {}, {}
        tile_ids = np.asarray(timeslice.coords["tiles"])
        grid_shape = timeslice.attrs["grid_shape"]
        for vname in output_vars:
            images[vname] = self.assemble_images(
                batches, self.target_variables.index(vname), tile_ids, grid_shape,
                input_ivar=self.input_variables.index(vname))
            losses[vname] = dict(model=float(np.mean(m["sloss"])),
                                 interpolated=float(np.mean(m["interp_sloss"])))
        return images, losses

    def assemble_images(self, batches: List[Dict[str, np.ndarray]], ivar: int,
                        tile_ids: np.ndarray, grid_shape: Dict[str, int],
                        input_ivar: Optional[int] = None) -> Dict[str, LArray]:
        """tile-id → (row, col) mosaic with NaN fill for dropped tiles
        (reference: dual_trainer.py:449-480). ``input_ivar`` selects the
        'input' panel's channel when target ⊂ input leaves the input with
        more channels than the target-shaped panels."""
        assembled: Dict[str, LArray] = {}
        itypes = list(batches[0].keys()) if batches else []
        for image_type in itypes:
            civ = input_ivar if (image_type == "input" and input_ivar is not None) else ivar
            tidx = 0
            block_grid: Optional[List[List[np.ndarray]]] = None
            for b in batches:
                arr = b[image_type][:, civ]
                tile_shape = list(arr.shape[-2:])
                if block_grid is None:
                    empty = np.full(tile_shape, np.nan, np.float32)
                    block_grid = [[empty] * grid_shape["x"] for _ in range(grid_shape["y"])]
                for i in range(arr.shape[0]):
                    tid = int(tile_ids[tidx])
                    ty, tx = tid // grid_shape["x"], tid % grid_shape["x"]
                    block_grid[ty][tx] = arr[i]
                    tidx += 1
            image = np.block(block_grid)
            coords = {cn: np.arange(0.0, 100.0, 100.0 / image.shape[ic])
                      for ic, cn in enumerate(("y", "x"))}
            assembled[image_type] = LArray(image, ["y", "x"], coords)
        return assembled

    # ----------------------------------------------------- region inference
    def _prepare_region_inputs(self, ctime: TimeType):
        """Host prep of one region timeslice: load, pad to every slot of the
        grid, and the denorm scale and offset (x·scale + offset) of each slot
        and input channel; on the card's path the arrays come back in pinned
        memory; first, the seconds it took. Numpy only, so it may run on a
        prefetch thread (infer_region_stream); holds ``loader_lock`` for the
        stateful load and select."""
        t0 = time.perf_counter()
        with self.loader_lock:
            timeslice = self.dataset.load_timeslice(ctime)
            grid_shape = dict(timeslice.attrs["grid_shape"])
            nslots = grid_shape["x"] * grid_shape["y"]
            loader = self.dataset.srbatch.data_loader
            batch = loader.select_batch((0, timeslice.shape[0]))
        nch = len(self.input_variables)
        tile_hw = timeslice.shape[2:]
        hr = np.zeros((nslots, nch) + tuple(tile_hw), np.float32)
        weight = np.zeros((nslots,), np.float32)
        tile_ids = np.zeros((nslots,), np.int64)
        scale = np.ones((nslots, nch, 1, 1), np.float32)
        offset = np.zeros((nslots, nch, 1, 1), np.float32)
        if batch is not None:
            ntiles = batch.shape[0]
            hr[:ntiles] = batch.data
            weight[:ntiles] = 1.0
            tile_ids[:ntiles] = np.asarray(batch.coords["tiles"], np.int64)
            if "mean" in batch.attrs:
                scale[:ntiles] = batch.attrs["std"]
                offset[:ntiles] = batch.attrs["mean"]
            elif "max" in batch.attrs:
                scale[:ntiles] = batch.attrs["max"] - batch.attrs["min"]
                offset[:ntiles] = batch.attrs["min"]
        arrays = [torch.from_numpy(a) for a in (hr, weight, tile_ids, scale, offset)]
        if self.device.type == "cuda":
            arrays = [a.pin_memory() for a in arrays]
        # the seconds go back with the arrays: a prep thread does not write
        # the timers the calling thread reads
        return (time.perf_counter() - t0, grid_shape, *arrays)

    def _region_dispatch(self, prep_s: float, grid_shape: Dict[str, int],
                         *arrays: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The region step, queued on the device: the padded batch of every
        grid slot → LR synthesis, forward, bicubic baseline, x·scale +
        offset, and each channel's tiles scattered into the region mosaic
        (``assemble_tiles``). Returns {panel: (C, Y, X)} on the device.

        Nothing is built per grid shape: the forward takes any batch, and
        the resize matrices are kept per size (``ops/resize.py``). The
        target, model and interpolated panels carry the target channels,
        each denormalized with its own variable's stats (JAX's region step
        broadcasts every input channel's stats over them,
        sres_tpu/trainer/trainer.py:737-740)."""
        self.timers["region_prep"] += prep_s
        t0 = time.perf_counter()
        hr, weight, ids, scale, offset = [a.to(self.device, non_blocking=True)
                                          for a in arrays]
        t1 = time.perf_counter()
        sc = self.step_config
        tidx = list(sc.target_idx)
        tscale, toffset = scale[:, tidx], offset[:, tidx]
        self.model.eval()
        with torch.inference_mode():
            lr, target = prepare_inputs(hr, sc)
            out = self.model(lr)
            interp = interp_baseline(lr, sc)
            panels = dict(target=target * tscale + toffset, model=out * tscale + toffset,
                          interpolated=interp * tscale + toffset, input=lr * scale + offset)
            images = {name: torch.stack([assemble_tiles(a[:, c], ids, grid_shape, weight)
                                         for c in range(a.shape[1])])
                      for name, a in panels.items()}
        self.timers["region_to_device"] += t1 - t0
        self.timers["region_dispatch"] += time.perf_counter() - t1
        return images

    def _region_fetch(self, images: Dict[str, torch.Tensor]):
        """Start the one device-to-host copy of a region's images: on the
        card, into a pinned buffer on a side stream that waits for the
        images (so the next region's work may go on meanwhile)."""
        names = list(images)
        shapes = [tuple(images[k].shape) for k in names]
        flat = torch.cat([images[k].reshape(-1) for k in names])
        if flat.device.type != "cuda":
            return names, shapes, flat, None, None
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        ready = torch.cuda.Event()
        ready.record()
        side = self._copy_stream()
        side.wait_event(ready)
        with torch.cuda.stream(side):
            host.copy_(flat, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return names, shapes, host, done, flat

    def _copy_stream(self) -> "torch.cuda.Stream":
        if self._d2h_stream is None:
            self._d2h_stream = torch.cuda.Stream(self.device)
        return self._d2h_stream

    def _region_result(self, fetch) -> Dict[str, Dict[str, LArray]]:
        """Wait for a region's copy to the host and wrap it: per target
        variable, each panel's channel of that variable ('input' the
        variable's input channel)."""
        names, shapes, host, done, _ = fetch
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        data = host.numpy()
        self.timers["region_to_host"] += time.perf_counter() - t0
        self.timers["regions"] += 1
        panels, at = {}, 0
        for k, s in zip(names, shapes):
            n = int(np.prod(s))
            panels[k] = data[at:at + n].reshape(s)
            at += n
        result: Dict[str, Dict[str, LArray]] = {}
        for ivar, vname in enumerate(self.target_variables):
            iin = self.input_variables.index(vname)
            result[vname] = {k: LArray(v[iin if k == "input" else ivar], ["y", "x"])
                             for k, v in panels.items()}
        return result

    def _load_best(self, update_model: bool) -> Optional[Dict[str, Any]]:
        """The best-validation checkpoint's metadata (its weights loaded in
        place with ``update_model``), timed as ``checkpoint_load``."""
        t0 = time.perf_counter()
        meta = self.checkpoint_manager.load_checkpoint(TSet.Validation,
                                                       update_model=update_model)
        self.timers["checkpoint_load"] += time.perf_counter() - t0
        return meta

    @staticmethod
    def _to_host(*tensors: torch.Tensor) -> List[np.ndarray]:
        """Device tensors → f32 numpy arrays by one copy (from the card into
        pinned memory)."""
        host = flat = torch.cat([t.reshape(-1).float() for t in tensors])
        if flat.is_cuda:
            host = torch.empty(flat.shape, pin_memory=True)
            host.copy_(flat)
        data, out, at = host.numpy(), [], 0
        for t in tensors:
            out.append(data[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        return out

    def _maybe_update_model(self, kwargs: Dict[str, Any]) -> None:
        if kwargs.get("update_model", False):
            self._load_best(True)

    def infer_region(self, ctime: TimeType, **kwargs) -> Dict[str, Dict[str, LArray]]:
        """Full-region tiled inference with assembly on the device: every tile
        of the timeslice runs through the model in ONE batch padded to the
        grid's slot count, results are denormalized and scattered into the
        region mosaic on the device, and only the four finished images per
        variable cross to the host (BASELINE.json config #5)."""
        if self.domain != batchDomain.Tiles:
            raise NotImplementedError(
                "infer_region requires a tiles-domain task (region datasets); "
                "time-domain tasks cover a single tile grid — use evaluate()")
        self._maybe_update_model(kwargs)
        prep = self._prepare_region_inputs(ctime)
        return self._region_result(self._region_fetch(self._region_dispatch(*prep)))

    def infer_region_stream(self, ctimes, prefetch: int = 2,
                            overlap_fetch: bool = False, **kwargs):
        """Pipelined multi-timeslice region inference: yields ``(ctime,
        result)`` like repeated :meth:`infer_region` calls, but
        - the host prep of slices t+1..t+prefetch runs on one worker thread
          while the device works on slice t; ``prefetch=0`` preps each
          slice on the calling thread instead (no thread: every kernel
          launch takes the interpreter lock back, so Python work on another
          thread slows the launch loop);
        - with ``overlap_fetch=True``, slice t+1 is queued before slice t's
          images are waited for; their copy to the host runs on a side
          stream meanwhile, and both slices' images are on the card at
          once."""
        from collections import deque

        if self.domain != batchDomain.Tiles:
            raise NotImplementedError(
                "infer_region_stream requires a tiles-domain task (region "
                "datasets); time-domain tasks cover a single tile grid")
        self._maybe_update_model(kwargs)
        prefetch = max(0, int(prefetch))
        ctimes = list(ctimes)
        pool = ThreadPoolExecutor(1, thread_name_prefix="region-prep") if prefetch else None

        def submit(ct):
            if pool is None:
                return ct, None
            return ct, pool.submit(self._prepare_region_inputs, ct)

        try:
            # one worker: the loader's prep is stateful (load_timeslice sets
            # the current slice before select_batch), so preps serialize
            preps = deque(submit(ct) for ct in ctimes[:max(prefetch, 1)])
            nxt = len(preps)
            pending = None          # (ctime, fetch) whose images are not read yet
            while preps:
                ctime, fut = preps.popleft()
                prep = self._prepare_region_inputs(ctime) if fut is None else fut.result()
                fetch = self._region_fetch(self._region_dispatch(*prep))
                if nxt < len(ctimes):
                    preps.append(submit(ctimes[nxt]))
                    nxt += 1
                if not overlap_fetch:
                    yield ctime, self._region_result(fetch)
                    continue
                if pending is not None:
                    yield pending[0], self._region_result(pending[1])
                pending = (ctime, fetch)
            if pending is not None:
                yield pending[0], self._region_result(pending[1])
        finally:
            if pool is not None:
                pool.shutdown(wait=True)

    # --------------------------------------------- seam-free overlapped inference
    def infer_region_seamless(self, ctime: TimeType, margin: int = 8, **kwargs
                              ) -> Dict[str, Dict[str, LArray]]:
        """Seam-free full-region inference: tiles are cut with a reflected
        halo of ``margin`` HR pixels so the network sees context across
        tile borders; after SR the halos are cropped and only the centers
        are assembled (data/overlap.py). ``margin`` must be a multiple of
        the scale. All six norm schemes; target ⊂ input is handled by
        channel-slicing the denorm stats. On the Winograd trunks the LR
        tile (tile + 2·margin/scale) must be a multiple of m: the model
        raises otherwise (48 + 4 at margin 8 is; 48 + 2 at margin 4 is
        not)."""
        assert margin % self.scale_factor == 0, \
            f"margin {margin} must be a multiple of the scale {self.scale_factor}"
        ntype = cfg().task.norm
        if self.domain != batchDomain.Tiles:
            raise NotImplementedError("seamless inference requires a tiles-domain task")
        self._maybe_update_model(kwargs)

        # loader_lock: region read + lazy sidecar compute serialize with a
        # live infer_region_stream prefetch worker (shared loader/sidecar)
        with self.loader_lock:
            region = self.dataset.load_region_data(ctime)       # (C, Y, X) raw
            grid = self.dataset.tile_grid
            ishape = dict(c=region.shape[0], y=region.shape[1], x=region.shape[2])
            gs = grid.get_grid_shape(image_shape=ishape)
            roi = grid.get_active_region(image_shape=ishape)
            active = region.data[:, roi["y"][0]:roi["y"][1], roi["x"][0]:roi["x"][1]]
            ts_hr = grid.get_full_tile_size()
            tiles, ids = extract_overlapped_tiles(active, ts_hr, gs, margin)
            if tiles.shape[0] == 0:
                return {}
            sidecar_stats = global_stats = None
            if ntype in ("tnorm", "tscale", "gnorm", "gscale"):
                loader = self.dataset.srbatch.data_loader
                if ntype in ("tnorm", "tscale"):
                    sidecar_stats = loader.sidecar.get(loader._timeslice_iter)
                    nrows = next(iter(sidecar_stats.values())).shape[0]
                    assert tiles.shape[0] == nrows, \
                        (f"region valid-tile count {tiles.shape[0]} != sidecar "
                         f"rows {nrows}: the NaN mask is not static")
                else:
                    global_stats = loader.sidecar.global_stats(loader._timeslice_iter)
        normed, stats = normalize_batch(tiles, ntype, (0, tiles.shape[0]),
                                        sidecar_stats, global_stats,
                                        list(self.input_variables))

        n = normed.shape[0]
        _, outputs = self._run_eval_step(normed, np.ones((n,), np.float32))
        lr, out, tar, interp = self._to_host(*outputs)

        m, mlr = margin, margin // self.scale_factor
        crop = lambda a, mm: a[:, :, mm:a.shape[2] - mm, mm:a.shape[3] - mm] if mm else a
        tstats = slice_stats(stats, self.step_config.target_idx)
        batches = [dict(input=denorm(crop(lr, mlr), stats),
                        target=denorm(crop(tar, m), tstats),
                        interpolated=denorm(crop(interp, m), tstats),
                        model=denorm(crop(out, m), tstats))]
        result: Dict[str, Dict[str, LArray]] = {}
        for ivar, vname in enumerate(self.target_variables):
            result[vname] = self.assemble_images(
                batches, ivar, ids, gs, input_ivar=self.input_variables.index(vname))
        return result

    # --------------------------------------------- whole-region inference
    def infer_region_spatial(self, ctime: TimeType, **kwargs
                             ) -> Dict[str, Dict[str, LArray]]:
        """Whole-region inference: the active region runs through the
        network as ONE image (B = 1), so there are no seams by construction
        (parallel/spatial.py). H is zero-padded to a multiple of the scale
        (one device; JAX pads to the mesh size times the scale) and cropped
        after; the region's NaN holes are filled with the channel mean
        before normalization and restored on the HR panels.

        All six norm schemes: local stats over the whole region; tnorm and
        tscale build per-pixel stats maps from the position-indexed sidecar
        rows (data/norm.py:tile_stats_maps); the global schemes normalize
        with the sidecar-global stats and, like the tiled path, return
        normalized panels. target ⊂ input is handled by channel-slicing."""
        ntype = cfg().task.norm
        if self.domain != batchDomain.Tiles:
            raise NotImplementedError("spatial inference requires a tiles-domain task")
        self._maybe_update_model(kwargs)

        with self.loader_lock:
            region = self.dataset.load_region_data(ctime)       # (C, Y, X) raw
            loader = self.dataset.srbatch.data_loader
            sidecar = (loader.sidecar.get(loader._timeslice_iter)
                       if ntype in ("tnorm", "tscale") else None)
            gstats = (loader.sidecar.global_stats(loader._timeslice_iter)
                      if ntype in ("gnorm", "gscale") else None)
        grid = self.dataset.tile_grid
        ishape = dict(c=region.shape[0], y=region.shape[1], x=region.shape[2])
        roi = grid.get_active_region(image_shape=ishape)
        gs = grid.get_grid_shape(image_shape=ishape)
        active = region.data[:, roi["y"][0]:roi["y"][1], roi["x"][0]:roi["x"][1]]

        sf = self.scale_factor
        ypad = -active.shape[1] % sf
        raw = active[None].astype(np.float32)
        nan_mask = ~np.isfinite(raw)
        fill = np.nanmean(raw, axis=(2, 3), keepdims=True)
        raw = np.where(nan_mask, fill, raw)
        if ntype in ("lnorm", "lscale"):
            normed, stats = normalize_batch(raw, ntype, (0, 1))
            hr_stats = lr_stats = stats
        elif ntype in ("tnorm", "tscale"):
            grid_hw = grid.get_full_tile_size()
            d = active.reshape(active.shape[0], gs["y"], grid_hw["y"], gs["x"], grid_hw["x"])
            finite = np.isfinite(d).all(axis=(0, 2, 4))      # (gy, gx)
            valid_ids = np.flatnonzero(finite.ravel())
            hr_stats = tile_stats_maps(valid_ids, gs, grid_hw, active.shape[1:], sidecar,
                                       list(self.input_variables), ntype)
            # tile-constant maps downsample exactly by strided slicing
            lr_stats = {k: v[:, :, ::sf, ::sf] for k, v in hr_stats.items()}
            normed = normalize_with_attrs(raw, hr_stats)
        else:   # gnorm / gscale: normalize globally; panels stay normalized
            col = lambda i: np.asarray([gstats[v][i] for v in self.input_variables],
                                       np.float32).reshape(1, -1, 1, 1)
            if ntype == "gnorm":
                ga = {"mean": col(0), "std": np.sqrt(col(1))}
            elif ntype == "gscale":
                ga = {"max": col(2), "min": col(3)}
            else:
                raise ValueError(f"Unknown norm: {ntype}")
            normed = normalize_with_attrs(raw, ga)
            hr_stats = lr_stats = {}
        hr = np.pad(normed, ((0, 0), (0, 0), (0, ypad), (0, 0)))

        sc = self.step_config
        with torch.inference_mode():
            lr = downsample(self._to_device(hr), float(sf), sc.down_mode)
            out = infer_region_sharded(self.model, lr)
            interp = upsample(lr, float(sf), sc.up_mode)
        lr, out, interp = self._to_host(lr, out, interp)
        crop = lambda a, s: a[:, :, : a.shape[2] - ypad // s if ypad else None, :]
        tidx = list(sc.target_idx)
        t_hr_stats = slice_stats(hr_stats, tidx)
        panels = dict(
            input=denorm(crop(lr, sf), lr_stats),
            target=denorm(crop(hr, 1)[:, tidx], t_hr_stats),
            model=denorm(crop(out, 1), t_hr_stats),
            interpolated=denorm(crop(interp, 1)[:, tidx], t_hr_stats),
        )
        # restore the region's NaN holes on the full-res panels
        tgt_mask = nan_mask[:, tidx]
        for key in ("target", "model", "interpolated"):
            panels[key] = np.where(tgt_mask, np.nan, panels[key])
        result: Dict[str, Dict[str, LArray]] = {}
        for ivar, vname in enumerate(self.target_variables):
            result[vname] = {
                k: LArray(v[0, ivar if k != "input" else
                            self.input_variables.index(vname)], ["y", "x"])
                for k, v in panels.items()}
        return result


def _stats(attrs: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The denorm stats among a batch's attrs."""
    return {k: attrs[k] for k in ("mean", "std", "max", "min") if k in attrs}
