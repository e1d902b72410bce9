"""Checkpoint manager (counterpart of sres_tpu/trainer/checkpoints.py;
reference sres/controller/checkpoints.py): two rolling slots, train (the
latest) and valid (the best validation loss), each with a ``.backup`` of
the file it replaces, and epoch/itime/loss metadata for resume.

A checkpoint holds the model's state dict in the reference's naming (which
the port's modules use) and the optimizer's (Adam moments and step counts),
in one file: ``MAGIC``, the length of a header, the header (a small
``torch.save`` of the metadata and of both state dicts with each tensor
replaced by ``("__tensor__", i)``, plus each tensor's dtype, shape and byte
range), then the tensors' bytes, concatenated. ``read_checkpoint`` gives
back the state dicts. The save concatenates the tensors on the card and
queues one copy into a pinned host buffer without waiting for it; a writer
thread waits for it and writes the file in two writes
(``pipeline.async_checkpoint``), so the host goes on queuing steps. The
step loop gives the interpreter lock up at each of its thousands of kernel
launches, so any Python work on another thread slows it: ``torch.save`` of
the tensors on the writer thread made it 2-3x slower (PERF.md §6).
The JAX package's msgpack checkpoints are not read (flax is absent on the
card), and ``pipeline.checkpoint_backend: orbax`` is not ported.
"""
from __future__ import annotations

import io
import os
import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from sres_tpu_torch.config import cfg
from sres_tpu_torch.data.inference_io import TSet
from sres_tpu_torch.util.logging import lgm

MAGIC = b"SRES-CKPT-1\n"


def _skeleton(obj: Any, tensors: List[torch.Tensor]) -> Any:
    """``obj`` with each tensor replaced by ``("__tensor__", i)``, the
    tensors appended to ``tensors`` in order."""
    if isinstance(obj, torch.Tensor):
        tensors.append(obj)
        return ("__tensor__", len(tensors) - 1)
    if isinstance(obj, dict):
        return {k: _skeleton(v, tensors) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_skeleton(v, tensors) for v in obj)
    return obj


def _fill(obj: Any, tensors: List[torch.Tensor]) -> Any:
    if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == "__tensor__":
        return tensors[obj[1]]
    if isinstance(obj, dict):
        return {k: _fill(v, tensors) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_fill(v, tensors) for v in obj)
    return obj


def _header(skeleton: Any, tensors: List[torch.Tensor], **meta: Any) -> bytes:
    """The file's header: the metadata, the state with tensors replaced,
    and each tensor's dtype, shape and byte range in the data that
    follows."""
    table, offset = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        table.append((str(t.dtype).split(".")[-1], tuple(t.shape), offset, n))
        offset += n
    buf = io.BytesIO()
    torch.save(dict(skeleton, tensors=table, **meta), buf)
    return buf.getvalue()


def _write(path: str, head: bytes, data: torch.Tensor,
           ready: Optional[torch.cuda.Event]) -> None:
    """Write the header and the tensors' bytes (a host buffer that
    ``ready`` completes) through a temporary file; the previous file
    becomes the ``.backup``. Two writes and no Python work a tensor, so a
    writer thread holds the interpreter lock for next to nothing."""
    if ready is not None:
        ready.synchronize()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC + len(head).to_bytes(8, "little") + head)
        f.write(data.numpy().data)
    if os.path.isfile(path):
        os.replace(path, path + ".backup")
    os.replace(tmp, path)


def read_checkpoint(path: str, tensors: bool = True,
                    device: Optional[torch.device] = None) -> Dict[str, Any]:
    """A checkpoint file → {'epoch', 'itime', 'loss', 'interp_loss',
    'model': state dict, 'optimizer': state dict}; with ``tensors=False``
    the metadata alone (no tensor is read). The tensors' bytes are read in
    one go into one buffer (pinned for a CUDA ``device``), which one copy
    takes to ``device``; every tensor is a view of it."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path} is not a checkpoint of this package")
        n = int.from_bytes(f.read(8), "little")
        header = torch.load(io.BytesIO(f.read(n)), weights_only=True)
        table = header.pop("tensors")
        if not tensors:
            return {k: v for k, v in header.items() if k not in ("model", "optimizer")}
        size = os.fstat(f.fileno()).st_size - f.tell()
        if sum(e[3] for e in table) != size:
            raise ValueError(f"{path} is truncated")
        on_card = device is not None and torch.device(device).type == "cuda"
        buf = torch.empty(size, dtype=torch.uint8, pin_memory=on_card)
        if size and f.readinto(memoryview(buf.numpy())) != size:
            raise ValueError(f"{path} is truncated")
    if device is not None:
        buf = buf.to(device, non_blocking=True)
    loaded = []
    for dt, shape, off, nb in table:
        dtype = getattr(torch, dt)
        t = buf[off:off + nb]
        if off % dtype.itemsize:
            t = t.clone()
        loaded.append(t.view(dtype).reshape(shape) if nb else
                      torch.empty(shape, dtype=dtype, device=buf.device))
    return _fill(header, loaded)


class _AsyncWriter:
    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None

    def _ensure(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="checkpoint-writer")
            self._thread.start()

    def _run(self):
        while True:
            args = self._q.get()
            try:
                _write(*args)
            except Exception as e:  # pragma: no cover
                lgm().exception(f"checkpoint write failed: {e}")
            finally:
                self._q.task_done()

    def submit(self, *args):
        self._ensure()
        self._q.put(args)

    def flush(self):
        self._q.join()


class _Snapshot:
    """A state's tensors as one host buffer: their bytes concatenated on
    their device (a few launches, not one copy a tensor: RCAN-10-20-64's
    model and Adam state are 6520 tensors), then one copy, queued on the
    card's stream into a pinned buffer kept from save to save."""

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None

    def take(self, state: Any) -> Tuple[Any, List[torch.Tensor], torch.Tensor,
                                        Optional[torch.cuda.Event]]:
        tensors: List[torch.Tensor] = []
        skeleton = _skeleton(state, tensors)
        with torch.no_grad():
            flat = torch.cat([t.detach().reshape(-1).view(torch.uint8) for t in tensors])
        on_card = flat.is_cuda
        if self._buf is None or self._buf.numel() != flat.numel():
            self._buf = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=on_card)
        self._buf.copy_(flat, non_blocking=on_card)
        ready = None
        if on_card:
            ready = torch.cuda.Event()
            ready.record()
        return skeleton, tensors, self._buf, ready


class CheckpointManager:
    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 async_write: Optional[bool] = None):
        if async_write is None:
            async_write = bool(cfg().pipeline.get("async_checkpoint", True))
        backend = str(cfg().pipeline.get("checkpoint_backend", "torch"))
        if backend not in ("torch", "flax"):
            raise NotImplementedError(f"pipeline.checkpoint_backend={backend} is not ported")
        self.model, self.optimizer = model, optimizer
        self.async_write = async_write
        self._writer = _AsyncWriter()
        self._snapshot = _Snapshot()

    @classmethod
    def checkpoint_path(cls, tset: TSet, backup: bool = False) -> str:
        vtset = TSet.Validation if tset == TSet.Test else tset
        path = f"{cfg().platform.results}/checkpoints/{cfg().task.training_version}.{vtset.value}"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        path += ".ckpt"
        return path + ".backup" if backup else path

    def save_checkpoint(self, epoch: int, itime: int, tset: TSet, loss: float,
                        interp_loss: float) -> str:
        # the previous write must be done before its buffer is refilled
        self.flush()
        skeleton, tensors, data, ready = self._snapshot.take(
            {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict()})
        head = _header(skeleton, tensors, epoch=int(epoch), itime=int(itime),
                       loss=float(loss), interp_loss=float(interp_loss))
        path = self.checkpoint_path(tset)
        if self.async_write:
            self._writer.submit(path, head, data, ready)
        else:
            _write(path, head, data, ready)
        lgm().log(f" *** SAVE {tset.name} checkpoint, loss={loss:.5f} ({interp_loss:.5f}) → {path}")
        return path

    def load_checkpoint(self, tset: TSet = TSet.Train, update_model: bool = True,
                        **_) -> Optional[Dict[str, Any]]:
        """{'epoch', 'itime', 'loss', 'interp_loss'}, {} when no checkpoint
        exists, None when neither the file nor its backup reads. With
        ``update_model`` the model's parameters and the optimizer's state
        are loaded in place."""
        self.flush()
        path = self.checkpoint_path(tset)
        if not os.path.exists(path):
            lgm().log(f"No checkpoint file found at '{path}': starting from scratch.")
            return {}
        blob = None
        for cand in (path, self.checkpoint_path(tset, backup=True)):
            if not os.path.exists(cand):
                continue
            try:
                blob = read_checkpoint(cand, tensors=update_model,
                                       device=self._device() if update_model else None)
                if cand != path:
                    lgm().log(f"Primary checkpoint corrupt; restored from backup {cand}",
                              display=True)
                break
            except Exception as e:
                lgm().log(f"Unable to load checkpoint {cand}: {e}", display=True)
        if blob is None:
            return None
        out = {"epoch": int(blob["epoch"]), "itime": int(blob["itime"]),
               "loss": float(blob["loss"]),
               "interp_loss": float(blob.get("interp_loss", 0.0))}
        if update_model:
            self.model.load_state_dict(blob["model"], strict=True)
            self.optimizer.load_state_dict(blob["optimizer"])
        lgm().log(f"Loaded model checkpoint from {path}", display=True)
        return out

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def clear_checkpoints(self) -> None:
        self.flush()
        for tset in (TSet.Train, TSet.Validation):
            for backup in (False, True):
                p = self.checkpoint_path(tset, backup)
                if os.path.exists(p):
                    os.remove(p)

    def flush(self) -> None:
        self._writer.flush()
