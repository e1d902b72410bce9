"""Winograd trunk blocks for ``model.winograd: 2|4`` (counterpart of
sres_tpu/models/wino_blocks.py).

``WinoConv`` and ``WinoResidualGroup`` hold exactly the parameters of
``layers.Conv`` and ``layers.ResidualGroup`` under the same names, so
checkpoints are winograd-agnostic; only ``forward`` differs. The
transform-domain weights U = G·w·Gᵀ are computed once per weight load (a
cache keyed by every parameter's version counter and storage, and by the
count of optimizer steps taken in the process) and kept in the activation
dtype.

Under autograd (grad enabled and an input or a parameter that requires
grad) the modules route through ``WinoConvFn`` and ``WinoGroupTrailFn``,
whose backward runs the hand-written backward kernels and returns each
parameter's gradient; U is rebuilt after every optimizer step. Under
``torch.no_grad()`` or ``torch.inference_mode()`` they run the
forward-only path.

``plain = True`` (see ``layers.set_plain_twins``) routes a module through the
kernels' plain-torch twins on any device; it exists for on-card
comparisons of the kernel path with its reference.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
from torch.optim.optimizer import register_optimizer_step_post_hook

from sres_tpu_torch.models.layers import Conv, ResidualGroup
from sres_tpu_torch.ops.winograd import transform_weights
from sres_tpu_torch.ops.winograd_conv import (WinoConvFn, WinoGroupTrailFn,
                                              wino_conv, wino_conv_plain,
                                              wino_group_fwd,
                                              wino_group_fwd_plain)


# A fused optimizer updates the parameters in place without bumping their
# version counters (torch._fused_adam_ does not), so every optimizer step
# also advances this count, which is part of the cache key.
_OPTIMIZER_STEPS = [0]


def _count_step(optimizer, args, kwargs) -> None:
    _OPTIMIZER_STEPS[0] += 1


register_optimizer_step_post_hook(_count_step)


def _key(module: nn.Module, dtype: torch.dtype) -> Tuple:
    return (dtype, _OPTIMIZER_STEPS[0]) + tuple(
        (p._version, p.data_ptr(), p.device) for p in module.parameters())


def _records_grad(module: nn.Module, *xs: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and (
        any(x is not None and x.requires_grad for x in xs)
        or any(p.requires_grad for p in module.parameters()))


def _bias(conv: Conv) -> torch.Tensor:
    if conv.bias is not None:
        return conv.bias.detach().float()
    return torch.zeros(conv.out_channels, device=conv.weight.device)


def group_params(group: ResidualGroup) -> List[Optional[torch.Tensor]]:
    """A residual group's parameters in the order the group autograd
    Functions take them: per RCAB conv1 w, b, conv2 w, b, CA conv 1 w, b, CA
    conv 2 w, b; then the trailing conv's w, b (None for an absent bias)."""
    blocks, trail = list(group.body)[:-1], group.body[-1]
    out: List[Optional[torch.Tensor]] = []
    for blk in blocks:
        ca = blk.body[3].conv_du
        for conv in (blk.body[0], blk.body[2], ca[0], ca[2]):
            out += [conv.weight, conv.bias]
    return out + [trail.weight, trail.bias]


class WinoConv(Conv):
    """3×3 conv through the Winograd kernel; parameters of ``layers.Conv``."""

    def __init__(self, cin: int, cout: int, m: int, bias: bool = True):
        super().__init__(cin, cout, 3, bias)
        self.m = m
        self.plain = False
        self._cache: Optional[Tuple] = None

    def _u(self, dtype: torch.dtype) -> torch.Tensor:
        key = _key(self, dtype)
        if self._cache is None or self._cache[0] != key:
            with torch.no_grad():
                u = transform_weights(self.weight, self.m).to(dtype)
            self._cache = (key, u)
        return self._cache[1]

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """conv(x) + bias, plus ``residual`` when given (RCAN's body conv
        and global skip)."""
        u = self._u(x.dtype)
        if _records_grad(self, x, residual):
            return WinoConvFn.apply(x, self.weight, self.bias, residual, u,
                                    self.m, self.plain)
        fn = wino_conv_plain if self.plain else wino_conv
        return fn(x, u, _bias(self), self.m, residual=residual)


class WinoResidualGroup(ResidualGroup):
    """nblocks × RCAB + trailing conv + group skip as one ``wino_group_fwd``
    call (trailing conv folded in); parameters of ``layers.ResidualGroup``."""

    def __init__(self, features: int, reduction: int, nblocks: int, m: int,
                 bias: bool = True):
        super().__init__(features, 3, reduction, nblocks, bias)
        self.m = m
        self.plain = False
        self._cache: Optional[Tuple] = None

    def _operands(self, dtype: torch.dtype) -> Tuple:
        key = _key(self, dtype)
        if self._cache is None or self._cache[0] != key:
            with torch.no_grad():
                self._cache = (key, self._collect(dtype))
        return self._cache[1]

    def _collect(self, dtype: torch.dtype) -> Tuple:
        blocks, trail = list(self.body)[:-1], self.body[-1]
        ws, bv, cw1, cb1, cw2, cb2 = [], [], [], [], [], []
        for blk in blocks:
            c1, c2, ca = blk.body[0], blk.body[2], blk.body[3]
            ws.append(torch.stack([transform_weights(c.weight, self.m)
                                   for c in (c1, c2)]))
            bv.append(torch.stack([_bias(c1), _bias(c2)]))
            d1, d2 = ca.conv_du[0], ca.conv_du[2]
            cw1.append(d1.weight.detach()[:, :, 0, 0].float())
            cb1.append(_bias(d1))
            cw2.append(d2.weight.detach()[:, :, 0, 0].float())
            cb2.append(_bias(d2))
        st = torch.stack
        return (st(ws).to(dtype), st(bv), st(cw1), st(cb1), st(cw2), st(cb2),
                transform_weights(trail.weight, self.m).to(dtype), _bias(trail))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ops = self._operands(x.dtype)
        if _records_grad(self, x):
            return WinoGroupTrailFn.apply(x, ops, self.m, self.plain,
                                          *group_params(self))
        fn = wino_group_fwd_plain if self.plain else wino_group_fwd
        ws, bv, cw1, cb1, cw2, cb2, wt, bt = ops
        return fn(x, ws, bv, cw1, cb1, cw2, cb2, self.m, wt, bt)

