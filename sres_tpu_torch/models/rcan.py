"""RCAN — residual channel-attention network (counterpart of
sres_tpu/models/rcan.py; reference sres/model/rcan/network.py).

head conv → nlayers × ResidualGroup(nblocks × RCAB) → body conv → global
skip → pixel-shuffle upsampler → tail conv. Parameter names are the
reference's (``head.0``, ``body.{g}.body.{b}.body.{0,2}``,
``body.{g}.body.{b}.body.3.conv_du.{0,2}``, ``body.{g}.body.{nb}``,
``body.{nl}``, ``tail.0.{0,2}``, ``tail.1``), so
``sres_tpu.util.torch_export.export_rcan`` output loads with strict=True.

``winograd`` = 2|4 runs the trunk — every residual group and the body conv —
through the Winograd kernels (models/wino_blocks.py) in channels_last
memory; the parameter set is the same as the direct path's. Unlike the JAX
model, an unsupported geometry (H or W not a multiple of m) raises instead
of falling back to the direct path.

``use_bias`` (``model.bias``) reaches the head, the body conv and the tail
conv only, as in JAX (sres_tpu/models/rcan.py:67, 118/135/158, 176): the
RCAB convs, each group's trailing conv and the upsampler always have a
bias, on every trunk.

``fused`` runs every residual group through the direct-conv group kernels
(models/fused.py) in channels_last memory; the body conv and the global
skip stay as in the direct path (sres_tpu/models/rcan.py:158-161), and
``fused`` wins over ``winograd`` (:85). The JAX model always lane-packs the
fused trunk and pads an odd batch to the pack (:76-80); here each tile runs
at C = 64, so there is nothing to pad.

``quantization`` (``int8``, ``int8_fused``, ``int8_full``;
ops/int8_conv.py) quantizes both convs of every RCAB, every group's
trailing conv and the body conv (rcan.py:147-161); the CA, head, upsampler
and tail stay in full precision. It switches the Winograd trunk off, as in
JAX (:84-87). With ``fused`` the groups run the fused kernels unquantized
and only the body conv is quantized (:147-150, :158-160). The activation
scales are shared by the tiles that JAX packs together: ``lane_pack`` of
them when the batch holds that many, else 1; always 2 under ``fused``
(:76), even at batch 1.

``remat_trunk`` checkpoints each residual group of the direct trunk
(``torch.utils.checkpoint``, non-reentrant; the recompute quantizes again
with the same scales). None means on under ``int8_full`` (JAX's default,
rcan.py:50-58, :98-100: its int8 activation stash per conv otherwise
fills the device) and off otherwise; the Winograd and fused trunks ignore
it, as JAX does.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from sres_tpu_torch.models.fused import FusedResidualGroup
from sres_tpu_torch.models.layers import Conv, ResidualGroup, SPUpsample
from sres_tpu_torch.models.registry import resolve_parms
from sres_tpu_torch.models.wino_blocks import WinoConv, WinoResidualGroup
from sres_tpu_torch.ops.int8_conv import check_mode
from sres_tpu_torch.ops.winograd import check_geometry


class RCAN(nn.Module):
    def __init__(self, nchannels_in: int, nchannels_out: int, nfeatures: int,
                 nlayers: int, nblocks: int, cbottleneck: int, kernel_size: int,
                 scale: int, use_bias: bool = True,
                 winograd: Optional[int] = None, fused: bool = False,
                 lane_pack: int = 1, quantization: Optional[str] = None,
                 remat_trunk: Optional[bool] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        quant = check_mode(quantization)
        if (fused or (winograd and not quant)) and kernel_size != 3:
            raise ValueError("model.winograd and model.fused need kernel_size 3")
        self.fused, self.quant = fused, quant
        self.winograd = None if fused or quant else winograd
        # the tiles that share an activation scale: JAX's pack (rcan.py:76)
        pack = 2 if fused else max(1, int(lane_pack))
        direct = not (fused or self.winograd)
        self.remat = direct and (quant == "int8_full" if remat_trunk is None
                                 else bool(remat_trunk))
        self.dtype = dtype
        nf, k = nfeatures, kernel_size
        self.head = nn.Sequential(Conv(nchannels_in, nf, k, use_bias))
        if fused:
            groups = [FusedResidualGroup(nf, cbottleneck, nblocks)
                      for _ in range(nlayers)]
            body_conv = Conv(nf, nf, k, use_bias, quant=quant, pack=pack)
        elif self.winograd:
            groups = [WinoResidualGroup(nf, cbottleneck, nblocks, winograd)
                      for _ in range(nlayers)]
            body_conv = WinoConv(nf, nf, winograd, use_bias)
        else:
            groups = [ResidualGroup(nf, k, cbottleneck, nblocks, quant, pack)
                      for _ in range(nlayers)]
            body_conv = Conv(nf, nf, k, use_bias, quant=quant, pack=pack)
        self.body = nn.Sequential(*groups, body_conv)
        self.tail = nn.Sequential(SPUpsample(scale, nf),
                                  Conv(nf, nchannels_out, k, use_bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, Cin, h, w) LR → (B, Cout, scale·h, scale·w) f32."""
        skip = self.head(x.to(self.dtype))
        if self.winograd:
            check_geometry(self.winograd, skip.shape[2], skip.shape[3])
            skip = skip.contiguous(memory_format=torch.channels_last)
            res = skip
            for group in list(self.body)[:-1]:
                res = group(res)
            res = self.body[-1](res, residual=skip)
        else:
            if self.fused or self.quant:
                skip = skip.contiguous(memory_format=torch.channels_last)
            remat = self.remat and torch.is_grad_enabled()
            res = skip
            for group in list(self.body)[:-1]:
                res = checkpoint(group, res, use_reentrant=False) if remat else group(res)
            res = self.body[-1](res) + skip
        return self.tail(res).float()


def build(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
          dtype: torch.dtype = torch.float32) -> RCAN:
    p = resolve_parms(model_cfg, dict(cbottleneck=2, nblocks=20, fused=False,
                                      pervar_heads=False, lane_pack=1,
                                      quantization=None, remat_trunk=None,
                                      winograd=None, winograd_bs=0,
                                      scan_groups=False),
                      nchannels_in=nchannels_in, nchannels_out=nchannels_out)
    # winograd_bs and scan_groups are TPU layout and compile-time levers:
    # accepted, no effect here (ROADMAP "leaves out"); lane_pack sets the
    # quantized convs' scale groups only
    if p["pervar_heads"]:
        raise NotImplementedError(
            "model.pervar_heads is not ported: ROADMAP Queue 1 item 3")
    return RCAN(
        nchannels_in=p["nchannels_in"], nchannels_out=p["nchannels_out"],
        nfeatures=p["nfeatures"], nlayers=p["nlayers"], nblocks=p["nblocks"],
        cbottleneck=p["cbottleneck"], kernel_size=p["kernel_size"],
        scale=p["scale"], use_bias=p["bias"],
        winograd=(int(p["winograd"]) if p["winograd"] else None),
        fused=bool(p["fused"]), lane_pack=int(p["lane_pack"]),
        quantization=p["quantization"], remat_trunk=p["remat_trunk"], dtype=dtype)
