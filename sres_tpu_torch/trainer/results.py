"""Loss-history persistence (counterpart of sres_tpu/trainer/results.py):
an append-only CSV of (tset, fractional_epoch, loss, ref_loss) rows, same
file format and path scheme as the reference so its TrainingPlot notebooks
read our runs unchanged
(reference: sres/model/manager.py:103-290 —
``{processed}/{task}_result_recs/{dataset}_{task}_{model}_losses.csv``).
"""
from __future__ import annotations

import csv
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from sres_tpu_torch.config import cfg
from sres_tpu_torch.data.inference_io import TSet
from sres_tpu_torch.util.logging import lgm


class ResultRecord:
    def __init__(self, tset: TSet, epoch: float, loss: float, ref_loss: float):
        self.tset, self.epoch, self.loss, self.ref_loss = tset, epoch, loss, ref_loss

    def serialize(self) -> List[str]:
        return [self.tset.value, f"{self.epoch:.3f}", f"{self.loss:.6f}", f"{self.ref_loss:.6f}"]

    def __str__(self):
        return (f" --- TSet: {self.tset.value}, Epoch: {self.epoch:.3f},  "
                f"Loss: {self.loss:.6f},  Ref Loss: {self.ref_loss:.6f}")


class ResultsAccumulator:
    def __init__(self, cc, save_dir: Optional[str] = None):
        self.results: List[ResultRecord] = []
        self.dataset = cc.dataset
        self.task = cc.task
        self.model = cc.model
        self.save_dir = save_dir or cfg().platform.processed
        self._pending: List[ResultRecord] = []

    def result_file_path(self) -> str:
        d = f"{self.save_dir}/{self.task}_result_recs"
        os.makedirs(d, exist_ok=True)
        return f"{d}/{self.dataset}_{self.task}_{self.model}_losses.csv"

    def refresh_state(self) -> None:
        p = self.result_file_path()
        if os.path.exists(p):
            os.rename(p, f"{p}.{int(time.time() / 10)}")
        self.results, self._pending = [], []

    def record_losses(self, tset: TSet, epoch: float, loss: float,
                      ref_loss: float, flush: bool = False) -> None:
        rr = ResultRecord(tset, float(epoch), float(loss), float(ref_loss))
        self.results.append(rr)
        self._pending.append(rr)
        if flush:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        with open(self.result_file_path(), "a", newline="\n") as f:
            w = csv.writer(f, delimiter=",", quotechar="|", quoting=csv.QUOTE_MINIMAL)
            for rr in self._pending:
                w.writerow(rr.serialize())
        self._pending = []

    def load_results(self) -> None:
        p = self.result_file_path()
        if not os.path.exists(p):
            return
        with open(p, "r", newline="") as f:
            for row in csv.reader(f, delimiter=",", quotechar="|"):
                if not row:
                    continue
                ref = float(row[3]) if len(row) > 3 else float("nan")
                self.results.append(ResultRecord(TSet(row[0]), float(row[1]), float(row[2]), ref))
        lgm().log(f" ** Loaded training stats ({len(self.results)} recs) from {p}")

    def get_plot_data(self) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
        """{series → epochs}, {series → losses} for model/ref × train/valid
        (reference: manager.py:264-281)."""
        x, y = {}, {}
        for dset in ("model", "ref"):
            for tset in (TSet.Train, TSet.Validation):
                pid = f"{dset}-{tset.value}"
                pts = {r.epoch: (r.loss if dset == "model" else r.ref_loss)
                       for r in self.results if r.tset == tset}
                x[pid] = np.array(list(pts.keys()))
                y[pid] = np.array(list(pts.values()))
        return x, y

    def rprint(self) -> None:
        print(f"\n---------------- {self.task} Results ----------------")
        print(f" * dataset: {self.dataset}\n * model: {self.model}")
        for r in self.results:
            print(str(r))
