"""The zarr export launcher (counterpart of scripts/processing/dset_to_zarr.py):

    python -m sres_tpu_torch.to_zarr --model rcan-10-20-64 --task SST-tiles-48 \\
        --dataset swot_20-20e --platform explore [--seed N] [key=value ...]

takes ``python -m sres_tpu_torch.train``'s arguments (the same groups and
dot-key overrides; the script's choices are the command above),
initializes the workflow and writes every time index's raw (channels, y,
x) region to ``{platform.processed}/{dataset}.zarr``
(``ModelTrainer.to_zarr``); prints the store's path. ``pipeline.device``
is ``auto`` (the card, where the trainer's model is built) unless set;
``pipeline.device=cpu`` is the only way onto the CPU.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from sres_tpu_torch.controller.workflow import WorkflowController
from sres_tpu_torch.train import parse_overrides


def main(argv: Optional[Sequence[str]] = None) -> str:
    """Run the launcher on ``argv`` (default: the process's arguments) and
    return the zarr store's path."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0], allow_abbrev=False)
    p.add_argument("--model", required=True)
    p.add_argument("--task", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--platform", default="explore")
    p.add_argument("--seed", type=int, default=None,
                   help="reproducible runs; default int(time.time()/60), as the reference")
    p.add_argument("overrides", nargs="*", help="dot-key overrides: dataset.dataset_root=DIR")
    args = p.parse_args(argv)
    configuration = dict(task=args.task, dataset=args.dataset, pipeline="sres",
                         platform=args.platform)
    kw = {} if args.seed is None else {"seed": args.seed}
    controller = WorkflowController("sres", configuration, **kw)
    controller.initialize("sres", args.model, **configuration,
                          **parse_overrides(args.overrides))
    zstore = controller.to_zarr()
    print(f"zarr store written to {zstore}")
    return zstore


if __name__ == "__main__":
    main()
