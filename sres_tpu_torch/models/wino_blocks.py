"""Winograd trunk blocks for ``model.winograd: 2|4`` (counterpart of
sres_tpu/models/wino_blocks.py).

``WinoConv`` and ``WinoResidualGroup`` hold exactly the parameters of
``layers.Conv`` and ``layers.ResidualGroup`` under the same names, and
``WinoResTrunk`` those of EDSR's direct trunk (``nn.Sequential`` of
``layers.ResBlock`` × nlayers and a ``layers.Conv``), so checkpoints are
winograd-agnostic; only ``forward`` differs. The
transform-domain weights U = G·w·Gᵀ are computed once per weight load (a
cache keyed by every parameter's version counter and storage, and by the
count of optimizer steps taken in the process) and kept in the activation
dtype: for the kernels (a CUDA input, ``plain`` unset) as a ``WinoU``, U
already in the orders the conv kernel and its adjoint read, so that no
call reorders or copies it; for the plain twins in natural order. The
caches are built outside ``torch.inference_mode`` even when a serving
step fills them, so a training step after it can save them for backward.

Under autograd (grad enabled and an input or a parameter that requires
grad) the modules route through ``WinoConvFn``, ``WinoGroupTrailFn`` and
``WinoResGroupTrailFn``,
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

from sres_tpu_torch.models.layers import Conv, ResBlock, ResidualGroup
from sres_tpu_torch.ops.winograd import transform_weights
from sres_tpu_torch.ops.winograd_conv import (WinoConvFn, WinoGroupTrailFn,
                                              WinoResGroupTrailFn, kernel_u, wino_conv,
                                              wino_conv_plain, wino_group_fwd,
                                              wino_group_fwd_plain,
                                              wino_resgroup_fwd,
                                              wino_resgroup_fwd_plain)


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


def _kernel_order(module: nn.Module, x: torch.Tensor) -> bool:
    """Whether a forward on x runs the kernels (and so takes ``WinoU``s)."""
    return x.is_cuda and not module.plain


def _cached(module: nn.Module, key: Tuple, build) -> object:
    """module._cache[1], rebuilt by ``build()`` when the key changed: as
    normal tensors (outside inference mode) and off the autograd graph."""
    if module._cache is None or module._cache[0] != key:
        with torch.inference_mode(False), torch.no_grad():
            module._cache = (key, build())
    return module._cache[1]


def _records_grad(module: nn.Module, *xs: Optional[torch.Tensor]) -> bool:
    return torch.is_grad_enabled() and (
        any(x is not None and x.requires_grad for x in xs)
        or any(p.requires_grad for p in module.parameters()))


def _bias(conv: Conv) -> torch.Tensor:
    if conv.bias is not None:
        return conv.bias.detach().float()
    return torch.zeros(conv.out_channels, device=conv.weight.device)


def group_params(group: ResidualGroup) -> List[torch.Tensor]:
    """A residual group's parameters in the order the group autograd
    Functions take them: per RCAB conv1 w, b, conv2 w, b, CA conv 1 w, b, CA
    conv 2 w, b; then the trailing conv's w, b."""
    blocks, trail = list(group.body)[:-1], group.body[-1]
    out: List[torch.Tensor] = []
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

    def _u(self, dtype: torch.dtype, kernel: bool = False):
        """U in ``dtype``: natural, or with ``kernel`` a ``WinoU``."""
        def build():
            u = transform_weights(self.weight, self.m).to(dtype)
            return kernel_u(u) if kernel else u
        return _cached(self, _key(self, dtype) + (kernel,), build)

    def forward(self, x: torch.Tensor,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """conv(x) + bias, plus ``residual`` when given (RCAN's body conv
        and global skip)."""
        u = self._u(x.dtype, _kernel_order(self, x))
        if _records_grad(self, x, residual):
            return WinoConvFn.apply(x, self.weight, self.bias, residual, u,
                                    self.m, self.plain)
        fn = wino_conv_plain if self.plain else wino_conv
        return fn(x, u, _bias(self), self.m, residual=residual)


class WinoResidualGroup(ResidualGroup):
    """nblocks × RCAB + trailing conv + group skip as one ``wino_group_fwd``
    call (trailing conv folded in); parameters of ``layers.ResidualGroup``."""

    def __init__(self, features: int, reduction: int, nblocks: int, m: int):
        super().__init__(features, 3, reduction, nblocks)
        self.m = m
        self.plain = False
        self._cache: Optional[Tuple] = None

    def _operands(self, dtype: torch.dtype, kernel: bool = False) -> Tuple:
        return _cached(self, _key(self, dtype) + (kernel,),
                       lambda: self._collect(dtype, kernel))

    def _collect(self, dtype: torch.dtype, kernel: bool) -> Tuple:
        blocks, trail = list(self.body)[:-1], self.body[-1]
        ws, bv, cw1, cb1, cw2, cb2 = [], [], [], [], [], []
        b = lambda conv: conv.bias.detach().float()
        for blk in blocks:
            c1, c2, ca = blk.body[0], blk.body[2], blk.body[3]
            ws.append(torch.stack([transform_weights(c.weight, self.m)
                                   for c in (c1, c2)]))
            bv.append(torch.stack([b(c1), b(c2)]))
            d1, d2 = ca.conv_du[0], ca.conv_du[2]
            cw1.append(d1.weight.detach()[:, :, 0, 0].float())
            cb1.append(b(d1))
            cw2.append(d2.weight.detach()[:, :, 0, 0].float())
            cb2.append(b(d2))
        st = torch.stack
        order = kernel_u if kernel else (lambda u: u)
        return (order(st(ws).to(dtype)), st(bv), st(cw1), st(cb1), st(cw2), st(cb2),
                order(transform_weights(trail.weight, self.m).to(dtype)), b(trail))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ops = self._operands(x.dtype, _kernel_order(self, x))
        if _records_grad(self, x):
            return WinoGroupTrailFn.apply(x, ops, self.m, self.plain,
                                          *group_params(self))
        fn = wino_group_fwd_plain if self.plain else wino_group_fwd
        ws, bv, cw1, cb1, cw2, cb2, wt, bt = ops
        return fn(x, ws, bv, cw1, cb1, cw2, cb2, self.m, wt, bt)


class WinoResTrunk(nn.Sequential):
    """EDSR's trunk: nlayers × ResBlock + body conv + the global skip as one
    ungated ``wino_resgroup_fwd`` call (the JAX ``wino_resgroup_trail``);
    parameters of the direct trunk ``nn.Sequential(ResBlock × nlayers,
    Conv)`` under the same names. Its output includes the skip."""

    def __init__(self, features: int, nlayers: int, m: int,
                 res_scale: float = 1.0, bias: bool = True):
        super().__init__(*[ResBlock(features, 3, bias, res_scale)
                           for _ in range(nlayers)],
                         Conv(features, features, 3, bias))
        self.m, self.res_scale = m, res_scale
        self.plain = False
        self._cache: Optional[Tuple] = None

    def _convs(self) -> List[Conv]:
        """conv1, conv2 of each ResBlock in order, then the body conv."""
        blocks = list(self)[:-1]
        return [c for blk in blocks for c in (blk.body[0], blk.body[2])] + [self[-1]]

    def _operands(self, dtype: torch.dtype, kernel: bool = False) -> Tuple:
        def build():
            convs = self._convs()
            nb, c = len(convs) // 2, convs[0].out_channels
            u = transform_weights(torch.stack([cv.weight for cv in convs]),
                                  self.m).to(dtype)
            b = torch.stack([_bias(cv) for cv in convs])
            order = kernel_u if kernel else (lambda t: t)
            ws = order(u[:-1].reshape(nb, 2, *u.shape[1:]))
            return ws, b[:-1].reshape(nb, 2, c), order(u[-1]), b[-1]
        return _cached(self, _key(self, dtype) + (kernel,), build)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ops = self._operands(x.dtype, _kernel_order(self, x))
        if _records_grad(self, x):
            params = [p for cv in self._convs() for p in (cv.weight, cv.bias)]
            return WinoResGroupTrailFn.apply(x, ops, self.m, self.res_scale,
                                             self.plain, *params)
        fn = wino_resgroup_fwd_plain if self.plain else wino_resgroup_fwd
        ws, bv, wt, bt = ops
        return fn(x, ws, bv, self.m, wt, bt, self.res_scale)
