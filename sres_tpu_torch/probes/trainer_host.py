"""Where the trainer's wall goes beside its step, on the card.

    python -m sres_tpu_torch.probes.trainer_host     (on the card)

Trains RCAN-10-20-64 ``winograd: 4`` (bf16) for one epoch through the
launcher, as ``chip_smoke.py`` phase 25a does (the synthetic task, batch 36,
a 1920×1920 region of 10 timeslices, 2 batches a timeslice), under four
pipeline settings: as configured (a checkpoint after every timeslice,
written by a thread), ``async_checkpoint=False``, ``checkpoint_period=1000``
(one checkpoint, at the epoch's end) and the same without the timeslice
prefetch. Each run reports its wall a step over timeslices 2-8 (each
timeslice timed to the card's end), and the trainer's own step is then
timed alone on the epoch's padded batches, already on the card.

Then the step's host time (16 steps queued, then one synchronize) while
another thread repeats one piece of work: nothing, ``torch.save`` of the
model and Adam state (what a writer thread of ``torch.save`` files does),
the checkpoint writer's work (``checkpoints._write``: two writes), a 1 ms
sleep, the synthetic generator's field for a 1920×1920 region (the
prefetch thread's work); and the snapshot's main-thread time. The step loop gives the interpreter lock
up at each kernel launch, so Python work on another thread shows here.
Prints one JSON line a case with the card's name and power limit. Needs a
CUDA card and nvcc.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import tempfile
import threading
import time

import numpy as np

ARGS = ["--model", "rcan-10-20-64", "--task", "synthetic-tiles-48", "--dataset", "synthetic",
        "--platform", "local", "--seed", "42", "model.winograd=4",
        "dataset.image_size={y: 1920, x: 1920}", "dataset.ntimes=10", "task.nepochs=1"]


def main() -> int:
    import torch
    from sres_tpu_torch.data.synthetic import _field
    from sres_tpu_torch.train import main as train_main
    from sres_tpu_torch.trainer import checkpoints as ck
    from sres_tpu_torch.trainer.trainer import ModelTrainer
    if not torch.cuda.is_available():
        raise SystemExit("trainer_host needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    root = tempfile.mkdtemp(prefix="trainer_host_")
    run_slice, run_step = ModelTrainer._train_timeslice, ModelTrainer._run_train_step
    walls, batches = [], []

    def timed_slice(self, train_times, itime):
        s0, t0 = self.timers["steps"], time.perf_counter()
        out = run_slice(self, train_times, itime)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0, self.timers["steps"] - s0))
        return out

    def capture(self, hr, weight):
        batches.append((hr.copy(), weight.copy()))
        return run_step(self, hr, weight)

    def say(**kv):
        print(json.dumps(dict(probe="trainer_host", card=card, **kv)), flush=True)

    def steps_ms(step, stage, n=16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            step(*stage[i % len(stage)])
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return 1e3 * (t1 - t0) / n, 1e3 * (time.perf_counter() - t0) / n

    ModelTrainer._train_timeslice, ModelTrainer._run_train_step = timed_slice, capture
    try:
        tr = None
        settings = (("as configured", []),
                    ("async_checkpoint=False", ["pipeline.async_checkpoint=False"]),
                    ("checkpoint_period=1000", ["pipeline.checkpoint_period=1000"]),
                    ("checkpoint_period=1000, no prefetch",
                     ["pipeline.checkpoint_period=1000", "pipeline.prefetch=False"]))
        for run, (label, extra) in enumerate(settings):
            walls.clear()
            batches.clear()
            t0 = time.perf_counter()
            tr = train_main(ARGS + [f"platform.root={root}/{run}"] + extra).trainer
            wall = time.perf_counter() - t0
            steady = walls[1:]
            t = tr.timers
            say(case=label, epoch_wall_s=wall,
                trainer_ms_per_step=1e3 * sum(w for w, _ in steady) / sum(n for _, n in steady),
                timeslice_ms_per_step=[1e3 * w / max(n, 1) for w, n in walls],
                dispatch_ms_per_step=1e3 * t["dispatch"] / t["steps"],
                validation_s=t["valid"], test_s=t["test"])
    finally:
        ModelTrainer._train_timeslice, ModelTrainer._run_train_step = run_slice, run_step
    stage = [(torch.from_numpy(h).to(dev), torch.from_numpy(w).to(dev)) for h, w in batches]
    step = tr._train_step
    steps_ms(step, stage[:2], 2)                                    # warm-up
    host, wall = steps_ms(step, stage)
    say(case="the trainer's step alone", host_ms_per_step=host, wall_ms_per_step=wall)

    state = {"model": tr.model.state_dict(), "optimizer": tr.optimizer.state_dict()}
    snap = ck._Snapshot()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        skeleton, tensors, data, ready = snap.take(state)
        head = ck._header(skeleton, tensors, epoch=1, itime=0, loss=0.0, interp_loss=0.0)
        times.append(time.perf_counter() - t0)
    ready.synchronize()
    path = os.path.join(root, "probe.ckpt")
    host_state = ck._fill(skeleton, [t.cpu() for t in tensors])
    say(case="snapshot", main_thread_s=times, tensors=len(tensors), mbytes=data.numel() / 1e6)

    work = {"nothing": None,
            "torch.save of the state": lambda: torch.save(host_state, path + ".old"),
            "checkpoints._write": lambda: ck._write(path, head, data, None),
            "sleep 1 ms": lambda: time.sleep(0.001),
            "a 1920x1920 synthetic field": lambda: _field(np.random.default_rng(1), 1920,
                                                          1920, 3.0)}
    for label, fn in list(work.items()) + [("nothing, again", None)]:
        stop, count = threading.Event(), [0]

        def loop():
            while not stop.is_set():
                fn()
                count[0] += 1

        th = threading.Thread(target=loop) if fn else None
        if th:
            th.start()
            time.sleep(0.05)
        host, wall = steps_ms(step, stage[:4], 8)
        stop.set()
        if th:
            th.join()
        say(case=f"background: {label}", host_ms_per_step=host, wall_ms_per_step=wall,
            background_iterations=count[0])
    shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
