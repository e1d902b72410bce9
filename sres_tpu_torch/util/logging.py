"""Singleton log manager (counterpart of sres_tpu/util/logging.py; reference
sres/base/util/logging.py).

Writes per-run log files under ``{platform.cache}/logs/{cid}.log`` with
optional console mirroring.
"""
from __future__ import annotations

import os
import sys
import traceback
from datetime import datetime
from typing import Optional


def lgm() -> "LogManager":
    return LogManager.instance()


class LogManager:
    _instance: Optional["LogManager"] = None

    def __init__(self):
        self._log_stream = None
        self.log_dir: Optional[str] = None
        self.log_file: Optional[str] = None

    @classmethod
    def instance(cls) -> "LogManager":
        if cls._instance is None:
            mgr = LogManager()
            mgr.init_logging()
            cls._instance = mgr
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        if cls._instance is not None:
            cls._instance.close()
        cls._instance = None

    def init_logging(self) -> None:
        from sres_tpu_torch.config import ConfigContext, cfg, cid
        if ConfigContext.cfg is not None:
            self.log_dir = f"{cfg().platform.cache}/logs"
            overwrite = cfg().task.get("overwrite_log", True)
            lid = "" if overwrite else f"-{os.getpid()}"
            self.log_file = f"{self.log_dir}/{cid()}{lid}.log"
            os.makedirs(os.path.dirname(self.log_file), exist_ok=True)
            self._log_stream = open(self.log_file, "w")

    def close(self) -> None:
        if self._log_stream is not None:
            self._log_stream.flush()
            self._log_stream.close()
            self._log_stream = None

    @property
    def ctime(self) -> str:
        return datetime.now().strftime("%H:%M:%S")

    def log(self, msg, display: bool = False, end: str = "\n") -> None:
        if self._log_stream is not None:
            self._log_stream.write(f"[{self.ctime}] {msg}\n")
            self._log_stream.flush()
        if display:
            # SRES_LOG_TO_STDERR=1: keep stdout clean for CLIs with a
            # machine-readable stdout contract (bench.py's one JSON line)
            out = sys.stderr if os.environ.get("SRES_LOG_TO_STDERR") == "1" else sys.stdout
            print(msg, flush=True, end=end, file=out)

    def exception(self, msg) -> None:
        error_msg = f"\n{msg}\n{traceback.format_exc()}\n"
        if self._log_stream is not None:
            self._log_stream.write(error_msg)
            self._log_stream.flush()
        print(error_msg, flush=True)
