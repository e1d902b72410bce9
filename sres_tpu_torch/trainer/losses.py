"""Padding-aware loss math on NCHW tensors (counterpart of
sres_tpu/trainer/losses.py; reference sres/controller/stats.py:5-8).

A ragged final batch is padded to the static batch size with per-tile 0/1
weights; every reduction normalises by the weighted element count so padded
tiles contribute nothing.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

EPS = 1e-6


def conform_to_product(prd: torch.Tensor, tar: torch.Tensor) -> torch.Tensor:
    """Crop the target to the product's spatial shape."""
    if tar.shape[2] > prd.shape[2] or tar.shape[3] > prd.shape[3]:
        tar = tar[:, :, : prd.shape[2], : prd.shape[3]]
    return tar


def _weighted_mean(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Mean over all elements with per-sample (leading-dim) 0/1 weights."""
    w = weight.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)
    per_elem = x[0].numel()
    return torch.sum(x * w) / (torch.sum(weight) * per_elem + 1e-12)


def l2loss(prd: torch.Tensor, tar: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    tar = conform_to_product(prd, tar)
    return torch.sqrt(_weighted_mean((prd - tar) ** 2, weight))


def charbonnier(prd: torch.Tensor, tar: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    tar = conform_to_product(prd, tar)
    return _weighted_mean(torch.sqrt((prd - tar) ** 2 + EPS), weight)


def single_product_loss(prd: torch.Tensor, tar: torch.Tensor,
                        weight: torch.Tensor, loss_fn: str) -> torch.Tensor:
    if loss_fn == "l2":
        return l2loss(prd, tar, weight)
    if loss_fn == "charbonnier":
        return charbonnier(prd, tar, weight)
    raise ValueError(f"Unknown loss_fn {loss_fn}")


def sr_loss(products: Union[torch.Tensor, Sequence[torch.Tensor]],
            targets: Union[torch.Tensor, List[torch.Tensor]], weight: torch.Tensor,
            loss_fn: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sloss, mloss): ``sloss`` is the final level's loss, ``mloss`` the
    training objective. For one product the two are equal; for a pyramid
    (one product a level, lowest first) ``mloss`` is the sum of every
    level's loss against its target (sres_tpu/trainer/losses.py:58-73;
    reference dual_trainer.py:221-234)."""
    if isinstance(products, torch.Tensor):
        sloss = single_product_loss(products, targets, weight, loss_fn)
        return sloss, sloss
    level_targets = targets if isinstance(targets, (list, tuple)) else [targets]
    sloss = single_product_loss(products[-1], level_targets[-1], weight, loss_fn)
    mloss = None
    for out, tar in zip(products, level_targets):
        ll = single_product_loss(out, tar, weight, loss_fn)
        mloss = ll if mloss is None else mloss + ll
    return sloss, mloss


def psnr(rmse: Union[float, torch.Tensor],
         data_range: Union[float, torch.Tensor] = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio from an RMSE."""
    rmse = torch.as_tensor(rmse, dtype=torch.float32)
    return 20.0 * torch.log10(torch.as_tensor(data_range) / torch.clamp_min(rmse, 1e-12))
