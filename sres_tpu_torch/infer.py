"""The inference launcher (counterpart of scripts/inference/inference-synthetic.py):

    python -m sres_tpu_torch.infer --model edsr --task synthetic-tiles-48 \\
        --dataset synthetic --platform local [--seed N] [key=value ...]

composes the config as ``python -m sres_tpu_torch.train`` does (the same
groups and dot-key overrides; the JAX launcher's ``model.nlayers=4
model.nfeatures=32`` are given here as overrides) and serves the model
from its best-validation checkpoint under ``platform.root`` (the weights as
built, from the seed, where there is none), in the JAX launcher's
sequence: ``Tiles`` at timesteps 0 and 1, ``Image`` at 0 (each saved as
NetCDF under ``{results}/inference/{dataset}/{task}/``), then the
``seamless`` and ``spatial`` region modes at 0, not saved. It prints where
the artifacts went. ``pipeline.device`` is ``auto`` (the card) unless set;
``pipeline.device=cpu`` is the only way onto the CPU.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from sres_tpu_torch.controller.workflow import WorkflowController
from sres_tpu_torch.data.inference_io import ResultStructure, results_path
from sres_tpu_torch.train import parse_overrides


def main(argv: Optional[Sequence[str]] = None) -> WorkflowController:
    """Run the launcher on ``argv`` (default: the process's arguments) and
    return the controller."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0], allow_abbrev=False)
    p.add_argument("--model", required=True)
    p.add_argument("--task", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--platform", default="explore")
    p.add_argument("--seed", type=int, default=None,
                   help="reproducible runs; default int(time.time()/60), as the reference")
    p.add_argument("overrides", nargs="*", help="dot-key overrides: model.nlayers=4")
    args = p.parse_args(argv)
    configuration = dict(task=args.task, dataset=args.dataset, pipeline="sres",
                         platform=args.platform)
    kw = {} if args.seed is None else {"seed": args.seed}
    controller = WorkflowController("sres", configuration, **kw)
    controller.initialize("sres", args.model, **configuration,
                          **parse_overrides(args.overrides))
    for ts in range(2):
        controller.inference(ts, ResultStructure.Tiles)
    controller.inference(0, ResultStructure.Image)
    controller.inference(0, ResultStructure.Image, region_mode="seamless", save=False)
    controller.inference(0, ResultStructure.Image, region_mode="spatial", save=False)
    var = controller.trainer.target_variables[0]
    print("inference artifacts written to "
          f"{os.path.dirname(results_path(var, 0, ResultStructure.Image))}")
    return controller


if __name__ == "__main__":
    main()
