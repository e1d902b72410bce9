"""Winograd trunk blocks for ``model.winograd: 2|4`` (counterpart of
sres_tpu/models/wino_blocks.py).

``WinoConv`` and ``WinoResidualGroup`` hold exactly the parameters of
``layers.Conv`` and ``layers.ResidualGroup`` under the same names, so
checkpoints are winograd-agnostic; only ``forward`` differs. The
transform-domain weights U = G·w·Gᵀ are computed once per weight load (a
cache keyed by every parameter's version counter and storage) and kept in
the activation dtype.

Forward only: the backward kernels (sres_tpu/ops/pallas/winograd_conv.py
:_bwd_kernel, wino_group_grad.py stash/chunk kernels) are not ported yet,
so calling these modules with autograd recording raises.

``plain = True`` (see ``set_plain_twins``) routes a module through the
kernels' plain-torch twins on any device; it exists for on-card
comparisons of the kernel path with its reference.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from sres_tpu_torch.models.layers import Conv, ResidualGroup
from sres_tpu_torch.ops.winograd import transform_weights
from sres_tpu_torch.ops.winograd_conv import (wino_conv, wino_conv_plain,
                                              wino_group_fwd,
                                              wino_group_fwd_plain)

_NO_BACKWARD = ("the Winograd path is forward-only: its backward kernels "
                "are ROADMAP Queue 2 items 2, 5 and 6 — run it under "
                "torch.no_grad() or torch.inference_mode()")


def _key(module: nn.Module, dtype: torch.dtype) -> Tuple:
    return (dtype,) + tuple((p._version, p.data_ptr(), p.device)
                            for p in module.parameters())


def _check_no_grad(module: nn.Module) -> None:
    if torch.is_grad_enabled() and any(p.requires_grad
                                       for p in module.parameters()):
        raise NotImplementedError(_NO_BACKWARD)


def _bias(conv: Conv) -> torch.Tensor:
    if conv.bias is not None:
        return conv.bias.detach().float()
    return torch.zeros(conv.out_channels, device=conv.weight.device)


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
        _check_no_grad(self)
        fn = wino_conv_plain if self.plain else wino_conv
        return fn(x, self._u(x.dtype), _bias(self), self.m, residual=residual)


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
        _check_no_grad(self)
        fn = wino_group_fwd_plain if self.plain else wino_group_fwd
        ws, bv, cw1, cb1, cw2, cb2, wt, bt = self._operands(x.dtype)
        return fn(x, ws, bv, cw1, cb1, cw2, cb2, self.m, wt, bt)


def set_plain_twins(model: nn.Module, plain: bool) -> nn.Module:
    """Route every Winograd module of ``model`` through the plain twins
    (True) or the kernels (False)."""
    for mod in model.modules():
        if isinstance(mod, (WinoConv, WinoResidualGroup)):
            mod.plain = plain
    return model
