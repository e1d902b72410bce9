"""The eval step (counterpart of sres_tpu/trainer/step.py:37-140, 308-335;
reference sres/controller/dual_trainer.py:557-571).

HR batch (NCHW) → bicubic ×4 downsample to the LR input → model forward →
masked loss against the HR target, plus the bicubic-upsample baseline loss.
Everything stays NCHW: the JAX step's NCHW→NHWC transpose is a TPU layout
cost and is not carried over.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple, Tuple

import torch

from sres_tpu_torch.ops.resize import downsample, interp_mode, upsample
from sres_tpu_torch.trainer.losses import sr_loss


class StepConfig(NamedTuple):
    """Static configuration distilled from the task and model configs."""
    scale: int
    downscale_factors: Tuple[int, ...]
    down_mode: str
    up_mode: str
    loss_fn: str
    data_downsample: float
    target_idx: Tuple[int, ...]   # channel indices of target variables
    nchannels_in: int
    has_bn: bool
    ntemporal: int = 0


def make_step_config(task: Mapping, model_cfg: Mapping, has_bn: bool = False,
                     ntemporal: int = 0) -> StepConfig:
    input_vars = list(task["input_variables"])
    target_vars = list(task["target_variables"])
    dsf = tuple(model_cfg.get("downscale_factors", (2, 2)))
    return StepConfig(
        scale=math.prod(dsf),
        downscale_factors=dsf,
        down_mode=interp_mode(task.get("downsample_mode", "cubic")),
        up_mode=interp_mode(task.get("upsample_mode", "cubic")),
        loss_fn=model_cfg.get("loss_fn", "l2"),
        data_downsample=float(task.get("data_downsample", 1.0)),
        target_idx=tuple(input_vars.index(v) for v in target_vars),
        nchannels_in=len(input_vars),
        has_bn=has_bn,
        ntemporal=ntemporal,
    )


def _select(x: torch.Tensor, sc: StepConfig) -> torch.Tensor:
    if len(sc.target_idx) == sc.nchannels_in:
        return x
    return x[:, list(sc.target_idx)]


def prepare_inputs(hr_nchw: torch.Tensor, sc: StepConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """HR batch → (lr_input, hr_target), both NCHW f32."""
    x = hr_nchw.float()
    if sc.data_downsample > 1.0:
        x = downsample(x, sc.data_downsample, sc.down_mode)
    target = _select(x, sc)
    lr = downsample(x, float(sc.scale), sc.down_mode)
    return lr, target


def _interp_baseline(lr: torch.Tensor, sc: StepConfig) -> torch.Tensor:
    """Bicubic-upsample baseline on the target channels."""
    return _select(upsample(lr, float(sc.scale), sc.up_mode), sc)


def build_eval_step(model: torch.nn.Module, sc: StepConfig) -> Callable:
    """Returns eval_step(hr_nchw, weight) -> (metrics, (lr, out, target,
    interp)): metrics holds 0-d f32 tensors ``mloss``, ``sloss`` and
    ``interp_sloss``; the four outputs are NCHW f32. Runs under
    ``torch.inference_mode`` with the model in eval mode."""
    if sc.has_bn or sc.ntemporal:
        raise NotImplementedError("BatchNorm and temporal-feature models are "
                                  "not ported yet (ROADMAP Queue 1 item 8)")

    def eval_step(hr: torch.Tensor, weight: torch.Tensor
                  ) -> Tuple[Dict[str, torch.Tensor], Tuple[torch.Tensor, ...]]:
        model.eval()
        with torch.inference_mode():
            lr, target = prepare_inputs(hr, sc)
            out = model(lr)
            sloss, mloss = sr_loss(out, target, weight, sc.loss_fn)
            interp = _interp_baseline(lr, sc)
            interp_sloss, _ = sr_loss(interp, target, weight, sc.loss_fn)
            metrics = dict(mloss=mloss, sloss=sloss, interp_sloss=interp_sloss)
            return metrics, (lr, out, target, interp)

    return eval_step
