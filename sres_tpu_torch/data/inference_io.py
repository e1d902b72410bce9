"""Result-set names (counterpart of sres_tpu/data/inference_io.py:29-34).

Only ``TSet``, which the trainer, its checkpoints and the loss CSV use; the
NetCDF result writers wait for the inference slice (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

from enum import Enum


class TSet(Enum):
    Train = "train"
    Validation = "valid"
    Test = "test"
    Upsample = "upsample"
