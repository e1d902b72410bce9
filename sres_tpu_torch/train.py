"""The training launcher (counterpart of scripts/train/train.py):

    python -m sres_tpu_torch.train --model rcan-10-20-64 --task SST-tiles-48 \\
        --dataset synthetic --platform local [--seed N] [-ne N] [-r] \\
        [key=value ...]

composes ``config/sres.yaml`` with the chosen groups and the dot-key
overrides (``task.nepochs=1``, ``pipeline.device=cpu``,
``dataset.image_size={y: 1920, x: 1920}``) and trains the model through
``WorkflowController``. ``pipeline.device`` is ``auto`` (the card) unless
set; ``pipeline.device=cpu`` is the only way onto the CPU. An override's
value is a Python literal when it reads as one, a YAML flow collection when
it starts with ``{`` or ``[``, else the string as written.
"""
from __future__ import annotations

import argparse
import ast
from typing import Any, Dict, List, Optional, Sequence

from sres_tpu_torch.controller.workflow import WorkflowController
from sres_tpu_torch.util import yamlite


def parse_value(text: str) -> Any:
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        pass
    if text[:1] in "{[":
        return yamlite.load(f"v: {text}")["v"]
    return text


def parse_overrides(overrides: List[str]) -> Dict[str, Any]:
    out = {}
    for ov in overrides:
        k, v = ov.split("=", 1)
        out[k] = parse_value(v)
    return out


def main(argv: Optional[Sequence[str]] = None) -> WorkflowController:
    """Run the launcher on ``argv`` (default: the process's arguments) and
    return the controller, whose ``trainer`` holds the trained model."""
    import sys
    argv = list(sys.argv[1:] if argv is None else argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0], allow_abbrev=False)
    p.add_argument("--model", required=True)
    p.add_argument("--task", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--platform", default="explore")
    p.add_argument("--seed", type=int, default=None,
                   help="reproducible runs; default int(time.time()/60), as the reference")
    # read again by WorkflowController.get_args; declared so that they do
    # not reach the overrides
    p.add_argument("-r", "--refresh", action="store_true")
    p.add_argument("-ne", "--nepochs", nargs="?", type=int)
    p.add_argument("overrides", nargs="*", help="dot-key overrides: task.lr=1e-4")
    args, _ = p.parse_known_args(argv)
    configuration = dict(task=args.task, dataset=args.dataset, pipeline="sres",
                         platform=args.platform)
    kw = {} if args.seed is None else {"seed": args.seed}
    controller = WorkflowController("sres", configuration, interp_loss=True,
                                    argv=argv, **kw)
    controller.train([args.model], **parse_overrides(args.overrides))
    return controller


if __name__ == "__main__":
    main()
