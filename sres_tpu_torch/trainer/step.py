"""The train and eval steps, their multi-step and gradient-accumulation
variants, and the optimizer (counterpart of sres_tpu/trainer/step.py:37-402;
reference sres/controller/dual_trainer.py:126, 296-323, 557-571).

HR batch (NCHW) → bicubic ×4 downsample to the LR input → model forward →
masked loss against the HR target, plus the bicubic-upsample baseline loss;
the train step also backpropagates the loss and takes one optimizer step,
updating the parameters in place (the JAX step donates its state).
Everything stays NCHW: the JAX step's NCHW→NHWC transpose is a TPU layout
cost and is not carried over.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, NamedTuple, Tuple

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


def interp_baseline(lr: torch.Tensor, sc: StepConfig) -> torch.Tensor:
    """Bicubic-upsample baseline on the target channels."""
    return _select(upsample(lr, float(sc.scale), sc.up_mode), sc)


def build_eval_step(model: torch.nn.Module, sc: StepConfig) -> Callable:
    """Returns eval_step(hr_nchw, weight) -> (metrics, (lr, out, target,
    interp)): metrics holds 0-d f32 tensors ``mloss``, ``sloss`` and
    ``interp_sloss``; the four outputs are NCHW f32. Runs under
    ``torch.inference_mode`` with the model in eval mode."""
    _check_ported(sc)

    def eval_step(hr: torch.Tensor, weight: torch.Tensor
                  ) -> Tuple[Dict[str, torch.Tensor], Tuple[torch.Tensor, ...]]:
        model.eval()
        with torch.inference_mode():
            lr, target = prepare_inputs(hr, sc)
            out = model(lr)
            sloss, mloss = sr_loss(out, target, weight, sc.loss_fn)
            interp = interp_baseline(lr, sc)
            interp_sloss, _ = sr_loss(interp, target, weight, sc.loss_fn)
            metrics = dict(mloss=mloss, sloss=sloss, interp_sloss=interp_sloss)
            return metrics, (lr, out, target, interp)

    return eval_step


def _param_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _check_ported(sc: StepConfig) -> None:
    if sc.has_bn or sc.ntemporal:
        raise NotImplementedError("BatchNorm and temporal-feature models are "
                                  "not ported yet (ROADMAP Queue 1 item 8)")


def _metrics(mloss, sloss, lr, target, weight, sc: StepConfig
             ) -> Dict[str, torch.Tensor]:
    """The step's metrics, with the bicubic baseline's loss."""
    with torch.no_grad():
        interp_sloss, _ = sr_loss(interp_baseline(lr, sc), target, weight,
                                  sc.loss_fn)
    return dict(mloss=mloss.detach(), sloss=sloss.detach(),
                interp_sloss=interp_sloss)


def _backward(model, hr, weight, sc: StepConfig):
    """Forward and backward of one batch's masked loss into ``.grad``."""
    lr, target = prepare_inputs(hr, sc)
    sloss, mloss = sr_loss(model(lr), target, weight, sc.loss_fn)
    mloss.backward()
    return mloss, sloss, lr, target


def build_train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                     sc: StepConfig) -> Callable:
    """Returns train_step(hr_nchw, weight) -> metrics: one Adam step on the
    masked loss (``mloss``), run on the device of the model's parameters;
    metrics holds 0-d f32 tensors ``mloss``, ``sloss`` and ``interp_sloss``
    (the JAX ``_train_step_core``, step.py:143-173)."""
    _check_ported(sc)
    dev = _param_device(model)

    def train_step(hr: torch.Tensor, weight: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        hr, weight = hr.to(dev), weight.to(dev)
        optimizer.zero_grad(set_to_none=True)
        mloss, sloss, lr, target = _backward(model, hr, weight, sc)
        optimizer.step()
        return _metrics(mloss, sloss, lr, target, weight, sc)

    return train_step


def _stack_metrics(metrics: List[Dict[str, torch.Tensor]]
                   ) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


def build_multi_train_step(model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer,
                           sc: StepConfig) -> Callable:
    """Returns multi_step(hr_stack, weight_stack) -> metrics: K optimizer
    steps over a staged (K, B, C, H, W) stack and its (K, B) weights, one
    ``build_train_step`` step each in order (the JAX ``lax.scan``,
    step.py:202-236, becomes a Python loop); each metric comes back as a
    (K,) tensor on the device."""
    step = build_train_step(model, optimizer, sc)
    dev = _param_device(model)

    def multi_step(hr_stack: torch.Tensor, weight_stack: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        hr_stack, weight_stack = hr_stack.to(dev), weight_stack.to(dev)
        return _stack_metrics([step(hr, w) for hr, w in zip(hr_stack, weight_stack)])

    return multi_step


def build_accum_train_step(model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer,
                           sc: StepConfig) -> Callable:
    """Returns accum_step(hr_stack, weight_stack) -> metrics: ONE optimizer
    update from K staged micro-batches (the JAX step.py:239-305). The
    gradient applied is sum_k where(sw_k > 0, sw_k * g_k, 0) / max(sum_k
    sw_k, 1e-12), sw_k the micro-batch's weight sum, all on the device
    (no host read of sw): K identical micro-batches reproduce the single
    step, and an all-padding micro-batch, whose RMSE gradient is NaN
    (d sqrt at 0 is inf), contributes exactly nothing. Metrics per
    micro-batch, (K,) tensors."""
    _check_ported(sc)
    dev = _param_device(model)
    params = [p for p in model.parameters() if p.requires_grad]

    def accum_step(hr_stack: torch.Tensor, weight_stack: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        model.train()
        hr_stack, weight_stack = hr_stack.to(dev), weight_stack.to(dev)
        gacc = [torch.zeros_like(p) for p in params]
        swacc = torch.zeros((), device=dev)
        metrics = []
        for hr, weight in zip(hr_stack, weight_stack):
            optimizer.zero_grad(set_to_none=True)
            mloss, sloss, lr, target = _backward(model, hr, weight, sc)
            sw = weight.sum()
            with torch.no_grad():
                for a, p in zip(gacc, params):
                    if p.grad is not None:
                        a.add_(torch.where(sw > 0, sw * p.grad, 0.0))
                swacc += sw
            metrics.append(_metrics(mloss, sloss, lr, target, weight, sc))
        with torch.no_grad():
            den = torch.clamp_min(swacc, 1e-12)
            for a, p in zip(gacc, params):
                p.grad = a.div_(den)
        optimizer.step()
        return _stack_metrics(metrics)

    return accum_step


def build_optimizer(model: torch.nn.Module, task: Mapping,
                    packed: bool = False) -> torch.optim.Optimizer:
    """Adam with the task's lr, or AdamW when ``weight_decay`` > 0 (the JAX
    ``build_optimizer``, step.py:338-362; optax's defaults b1 0.9, b2 0.999,
    eps 1e-8), over the model's parameters where they lie; ``fused=True``
    on the card. ``packed`` (pipeline.packed_opt) is a TPU graph-size lever:
    accepted, no effect. With ``task.scheduler`` the lr is set per epoch by
    ``set_learning_rate``."""
    del packed
    lr = float(task["lr"])
    wd = float(task.get("weight_decay", 0.0))
    fused = _param_device(model).type == "cuda"
    if wd > 0.0:
        opt = torch.optim.AdamW(model.parameters(), lr=lr, weight_decay=wd,
                                fused=fused)
    else:
        opt = torch.optim.Adam(model.parameters(), lr=lr, fused=fused)
    opt.scheduled = bool(task.get("scheduler", None))
    return opt


def lr_at_epoch(task: Mapping, epochs_completed: int) -> float:
    """Learning rate after ``epochs_completed`` per-epoch scheduler steps,
    with torch scheduler semantics (step.py:365-391). ``task.scheduler``:
      {type: step, step_size: N, gamma: g}
      {type: multistep, milestones: [..], gamma: g}
      {type: exponential, gamma: g}
      {type: cosine, t_max: N, eta_min: m}
    """
    lr0 = float(task["lr"])
    sched = task.get("scheduler", None)
    if not sched:
        return lr0
    stype = sched["type"]
    e = max(0, int(epochs_completed))
    if stype == "step":
        return lr0 * float(sched.get("gamma", 0.1)) ** (e // int(sched["step_size"]))
    if stype == "multistep":
        passed = sum(1 for m in sched["milestones"] if e >= int(m))
        return lr0 * float(sched.get("gamma", 0.1)) ** passed
    if stype == "exponential":
        return lr0 * float(sched["gamma"]) ** e
    if stype == "cosine":
        t_max = int(sched["t_max"])
        eta_min = float(sched.get("eta_min", 0.0))
        return eta_min + 0.5 * (lr0 - eta_min) * (1.0 + math.cos(math.pi * e / t_max))
    raise ValueError(f"Unknown scheduler type: {stype}")


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set the lr of every parameter group; no-op when the optimizer was
    built without a scheduler (step.py:394-402)."""
    if getattr(optimizer, "scheduled", False):
        for group in optimizer.param_groups:
            group["lr"] = float(lr)
