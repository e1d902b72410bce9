"""Temporal feature engineering (the port's own copy of sres_tpu/models/
temporal.py; reference sres/model/manager.py:30-40 get_temporal_features +
sres/base/source/batch.py:137-207 GraphCast-derived day/year-progress
features). numpy only: the trainer computes the features on the host and
feeds a (B, 4) row a batch to a UNet with ``use_temporal_features``."""
from __future__ import annotations

from typing import Optional

import numpy as np

SEC_PER_DAY = 86400
AVG_SEC_PER_YEAR = SEC_PER_DAY * 365.24219


def get_temporal_features(time: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """(T, 4) sin/cos of day and year progress relative to the first
    timestamp; None for None input (the reference's default path)."""
    if time is None:
        return None
    time = np.asarray(time)
    is_dt = np.issubdtype(time.dtype, np.datetime64)
    t0, pi2 = time[0], 2 * np.pi
    sday, syear = [], []
    for t in time:
        # numeric time coords (synthetic/LLC4320 indices) count days
        td = float((t - t0) / np.timedelta64(1, "D")) if is_dt else float(t - t0)
        sday.append((np.sin(td * pi2), np.cos(td * pi2)))
        ty = (float((t - t0) / np.timedelta64(365, "D")) if is_dt else td / 365.0)
        syear.append((np.sin(ty * pi2), np.cos(ty * pi2)))
    feats = np.concatenate([np.array(x, np.float32) for x in (sday, syear)], axis=1)
    return feats


def get_year_progress(seconds_since_epoch: np.ndarray) -> np.ndarray:
    """Fractional year progress in [0, 1) (reference: source/batch.py:137)."""
    years = seconds_since_epoch / AVG_SEC_PER_YEAR
    return np.mod(years, 1.0).astype(np.float32)


def get_day_progress(seconds_since_epoch: np.ndarray, longitude: np.ndarray) -> np.ndarray:
    """Per-longitude fractional day progress in [0, 1)
    (reference: source/batch.py:159)."""
    day_progress_greenwich = np.mod(seconds_since_epoch, SEC_PER_DAY) / SEC_PER_DAY
    longitude_offsets = np.deg2rad(longitude) / (2 * np.pi)
    return np.mod(day_progress_greenwich[..., np.newaxis] + longitude_offsets,
                  1.0).astype(np.float32)


def featurize_progress(progress: np.ndarray) -> dict:
    """{name: (progress, sin, cos)} triplet (reference: source/batch.py:181)."""
    return dict(progress=progress,
                progress_sin=np.sin(progress * 2 * np.pi).astype(np.float32),
                progress_cos=np.cos(progress * 2 * np.pi).astype(np.float32))
