"""WorkflowController — the public training API (counterpart of
sres_tpu/controller/workflow.py:21-61; reference sres/controller/workflow.py):
train a list of models, each in its own config context. Inference, the
zarr export and the result views wait for the inference slice (ROADMAP
Queue 1 items 5-6).

Unlike the JAX controller, a failure in training is not caught and logged:
it propagates, so a kernel or build fault stops the run.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from sres_tpu_torch.config import ConfigContext, cfg
from sres_tpu_torch.trainer.trainer import ModelTrainer
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
