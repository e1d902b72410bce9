"""The direct-conv residual group for ``model.fused: true`` (counterpart of
sres_tpu/models/fused.py:FusedResidualGroup).

``FusedResidualGroup`` holds exactly the parameters of
``layers.ResidualGroup`` under the same names, so one checkpoint loads into
the direct, the Winograd and the fused trunk alike (the JAX model's flat
stacked tree is converted on export, ``util/weights.py``). Its forward is
one group of ``ops/fused_group.py`` kernels: the operands (conv weights in
the kernels' layout and the activation dtype, their adjoints' flipped
weights, f32 biases) are built once per weight load and cached like the
Winograd trunk's (outside inference mode, so that serving and then
training in one process works).

Under autograd the group runs through ``FusedGroupFn``, which keeps the
forward's stash (each RCAB's input, ReLU output, conv2 output and gate:
about 1.29 GB per group at batch 72 of 48×48 tiles in bf16) for the
backward. The JAX model recomputes the group inside ``jax.checkpoint``
instead, because a v5e has 16 GB; an H100 holds the ten groups' stashes.
Under ``torch.no_grad()`` or ``torch.inference_mode()`` no stash is
written. There is no lane packing: each tile runs at C = 64, which is the
same function as the JAX path's block-diagonal packed weights.

``plain = True`` (``layers.set_plain_twins``) routes the group through the
kernels' plain-torch twins on any device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from sres_tpu_torch.models.layers import ResidualGroup
from sres_tpu_torch.models.wino_blocks import _cached, _key, _records_grad, group_params
from sres_tpu_torch.ops.fused_group import (FusedGroupFn, GroupOps, fused_group_fwd,
                                            fused_group_fwd_plain, group_ops)


class FusedResidualGroup(ResidualGroup):
    """nblocks × RCAB + trailing conv + group skip through the fused-group
    kernels; parameters of ``layers.ResidualGroup``."""

    def __init__(self, features: int, reduction: int, nblocks: int):
        super().__init__(features, 3, reduction, nblocks)
        self.plain = False
        self._cache: Optional[Tuple] = None

    def _operands(self, dtype: torch.dtype) -> GroupOps:
        return _cached(self, _key(self, dtype),
                       lambda: group_ops(list(self.body)[:-1], self.body[-1], dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ops = self._operands(x.dtype)
        if _records_grad(self, x):
            return FusedGroupFn.apply(x, ops, self.plain, *group_params(self))
        return (fused_group_fwd_plain if self.plain else fused_group_fwd)(x, ops)
