"""Padding-aware loss math on NCHW tensors (counterpart of
sres_tpu/trainer/losses.py; reference sres/controller/stats.py:5-8).

A ragged final batch is padded to the static batch size with per-tile 0/1
weights; every reduction normalises by the weighted element count so padded
tiles contribute nothing.
"""
from __future__ import annotations

from typing import Tuple, Union

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


def sr_loss(product: torch.Tensor, target: torch.Tensor, weight: torch.Tensor,
            loss_fn: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sloss, mloss) for a single-product model (the two are equal).
    Pyramid (multi-product) models are not ported yet (ROADMAP Queue 1
    item 8)."""
    if not isinstance(product, torch.Tensor):
        raise NotImplementedError("multiscale products are not ported yet "
                                  "(ROADMAP Queue 1 item 8)")
    sloss = single_product_loss(product, target, weight, loss_fn)
    return sloss, sloss


def psnr(rmse: Union[float, torch.Tensor],
         data_range: Union[float, torch.Tensor] = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio from an RMSE."""
    rmse = torch.as_tensor(rmse, dtype=torch.float32)
    return 20.0 * torch.log10(torch.as_tensor(data_range) / torch.clamp_min(rmse, 1e-12))
