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
``shard_map`` and ``memory_debug`` are accepted with no effect. Region
inference, ``process_image``, image assembly and ``to_zarr`` wait for the
inference slice (ROADMAP Queue 1 items 5-6).

``timers`` holds the host's seconds by part (``load``: a timeslice's
region → tiles, or the wait for its prefetch; ``assemble``: tile
selection, normalization and flips; ``pad``; ``to_device``; ``dispatch``:
queuing the steps; ``metrics_to_host``; ``train``: the timeslices' walls;
``valid``, ``test``) and counts: ``steps``, the train batches run;
``pad_batches``, the zero-weight micro-batches of accumulation tails;
``eval_steps``.
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
from sres_tpu_torch.data.tiles import TileIterator, batchDomain
from sres_tpu_torch.device import resolve_device
from sres_tpu_torch.models import build_model
from sres_tpu_torch.trainer.checkpoints import CheckpointManager
from sres_tpu_torch.trainer.losses import psnr
from sres_tpu_torch.trainer.results import ResultsAccumulator
from sres_tpu_torch.trainer.step import (build_accum_train_step, build_eval_step,
                                         build_multi_train_step, build_optimizer,
                                         build_train_step, lr_at_epoch,
                                         make_step_config, set_learning_rate)
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
            meta = self.checkpoint_manager.load_checkpoint(TSet.Validation,
                                                           update_model=update_model)
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
