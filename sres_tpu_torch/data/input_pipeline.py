"""Pipelined host-side input backends for the training loop (counterpart of
sres_tpu/data/input_pipeline.py).

The reference loads every batch synchronously on the training thread
(sres/controller/dual_trainer.py:303-318 — tile extraction, augmentation and
the H2D copy all serialize with the optimizer step); its only concession is a
DALI `num_workers` knob on the dead MERRA2 path (sres/config/pipeline/
sres.yaml). Here the host work (tile slicing, xyflip, padding) can overlap
the device step stream:

- ``sync``     — reference-sequential (default).
- ``threads``  — ONE producer thread runs the exact same sequential code and
  feeds a bounded queue, so the batch stream (including the numpy RNG draw
  order for xyflip) is bit-identical to ``sync`` while host assembly overlaps
  the card's steps. Depth is bounded (``pipeline.input_depth``) so at most
  that many padded batches are alive beyond the consumer's.
- ``grain``    — Google grain ``MapDataset → IterDataset`` with
  ``pipeline.num_workers`` read threads (grain is no dependency of the port:
  the backend is import-gated and falls back to ``threads`` with a warning).
  With >1 worker the shared-RNG draw order is undefined, so grain mode flips
  each batch with a per-tile derived seed (BatchDataset.flip_index_for):
  deterministic under any worker count, but a *different* (still seeded)
  augmentation stream than sync/threads.

Selected via ``pipeline.input_backend``; see config/pipeline/sres.yaml.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

from sres_tpu_torch.util.logging import lgm

BACKENDS = ("sync", "threads", "grain")

_SENTINEL = object()


def grain_available() -> bool:
    try:
        import grain.python  # noqa: F401
        return True
    except Exception:
        return False


def _iter_sync(producer: Callable[[Any], Optional[Any]],
               ctiles: Iterable[Any]) -> Iterator[Any]:
    for ctile in ctiles:
        item = producer(ctile)
        if item is None:  # missing data ends the timeslice (trainer `break`)
            return
        yield item


def _iter_threads(producer: Callable[[Any], Optional[Any]],
                  ctiles: Iterable[Any], depth: int) -> Iterator[Any]:
    q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def _produce() -> None:
        try:
            for ctile in ctiles:
                if stop.is_set():
                    return
                item = producer(ctile)
                if item is None:
                    break
                q.put(item)
        except BaseException as exc:  # re-raised on the consumer thread
            q.put((_SENTINEL, exc))
            return
        q.put(_SENTINEL)

    worker = threading.Thread(target=_produce, name="input-pipeline", daemon=True)
    worker.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
                raise item[1]
            yield item
    finally:
        # consumer abandoned the iterator (exception/break): unblock the
        # producer's q.put and let the daemon thread exit
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


def _iter_grain(producer: Callable[[Any], Optional[Any]],
                ctiles: Iterable[Any], depth: int, workers: int) -> Iterator[Any]:
    import grain.python as gp
    src = list(ctiles)
    ds = gp.MapDataset.source(src).map(producer)
    opts = gp.ReadOptions(num_threads=max(1, workers),
                          prefetch_buffer_size=max(1, depth))
    for item in ds.to_iter_dataset(read_options=opts):
        if item is None:
            return
        yield item


def iter_pipelined(producer: Callable[[Any], Optional[Any]],
                   ctiles: Iterable[Any],
                   backend: str = "sync",
                   depth: int = 2,
                   workers: int = 1) -> Iterator[Any]:
    """Yield ``producer(ctile)`` for each ctile until exhaustion or the first
    ``None`` (the trainer's missing-batch `break` contract), with host-side
    pipelining per `backend`."""
    if backend not in BACKENDS:
        raise ValueError(f"pipeline.input_backend must be one of {BACKENDS}, "
                         f"got '{backend}'")
    if backend == "grain" and not grain_available():
        lgm().log("pipeline.input_backend=grain but grain is not installed — "
                  "falling back to the 'threads' backend", display=True)
        backend = "threads"
    if backend == "sync":
        return _iter_sync(producer, ctiles)
    if backend == "threads":
        return _iter_threads(producer, ctiles, depth)
    return _iter_grain(producer, ctiles, depth, workers)
