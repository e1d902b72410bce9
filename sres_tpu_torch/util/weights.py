"""Weight transfer from the JAX package: flax variables (as numpy arrays) →
a torch state dict in the reference's naming, which the port's modules
load with ``strict=True``.

The port keeps its own copy of the JAX package's exporter for every
architecture (sres_tpu/util/torch_export.py:20-94 helpers, :109-378
exporters and ``export_variables``; "torch_import" in their docstrings
is sres_tpu/util/torch_import.py), and a numpy copy of
``sres_tpu.models.fused.rcan_params_from_fused`` (:129-147), so that a JAX
``model.fused`` tree (``FusedResidualGroup_{g}`` stacks) exports to the
same names as an unfused one; it imports nothing of the JAX package.
SwinIR's (``export_swinir``), which the JAX package lacks, maps both of its
attention trees onto the public SwinIR's names. Layout: flax conv kernels
(kh, kw, Cin, Cout) → torch (Cout, Cin, kh, kw); transposed-conv kernels →
(Cin, Cout, kh, kw) with the spatial mirror; Dense kernels (in, out) →
Linear weights (out, in); BatchNorm scale/bias and ``batch_stats`` mean/var
→ weight/bias, ``running_mean``/``running_var`` and ``num_batches_tracked``
(0, as the JAX exporter writes it).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

TorchState = Dict[str, np.ndarray]


def _unwrap(node: Dict[str, Any], key: str = "Conv_0") -> Dict[str, Any]:
    """The JAX layers.Conv nests the flax core one level down."""
    return node[key] if key in node and "kernel" not in node else node


def _conv_out(tw: TorchState, name: str, node: Dict[str, Any]) -> None:
    node = _unwrap(node)
    tw[f"{name}.weight"] = np.asarray(node["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in node:
        tw[f"{name}.bias"] = np.asarray(node["bias"])


def _convT_out(tw: TorchState, name: str, node: Dict[str, Any]) -> None:
    """flax ConvTranspose kernel (kh,kw,Cin,Cout) → torch (Cin,Cout,kh,kw)
    with the spatial mirror."""
    node = _unwrap(node, "ConvTranspose_0")
    k = np.asarray(node["kernel"]).transpose(2, 3, 0, 1)
    tw[f"{name}.weight"] = np.ascontiguousarray(k[:, :, ::-1, ::-1])
    if "bias" in node:
        tw[f"{name}.bias"] = np.asarray(node["bias"])


def _dense_out(tw: TorchState, name: str, node: Dict[str, Any]) -> None:
    tw[f"{name}.weight"] = np.asarray(node["kernel"]).T
    if "bias" in node:
        tw[f"{name}.bias"] = np.asarray(node["bias"])


def _bn_out(tw: TorchState, name: str, pnode: Dict[str, Any],
            snode: Optional[Dict[str, Any]]) -> None:
    core_p = pnode["BatchNorm_0"]
    tw[f"{name}.weight"] = np.asarray(core_p["scale"])
    tw[f"{name}.bias"] = np.asarray(core_p["bias"])
    core_s = (snode or {}).get("BatchNorm_0", {})
    nch = np.asarray(core_p["scale"]).shape[0]
    tw[f"{name}.running_mean"] = np.asarray(core_s.get("mean", np.zeros(nch)), np.float32)
    tw[f"{name}.running_var"] = np.asarray(core_s.get("var", np.ones(nch)), np.float32)
    tw[f"{name}.num_batches_tracked"] = np.asarray(0, np.int64)


def _prelu_out(tw: TorchState, name: str, node: Dict[str, Any]) -> None:
    tw[f"{name}.weight"] = np.asarray(node["alpha"])


def _scale_out(tw: TorchState, name: str, node: Dict[str, Any]) -> None:
    tw[f"{name}.scale"] = np.asarray(node["scale"])


def _ln_out(tw: TorchState, name: str, node: Dict[str, Any]) -> None:
    tw[f"{name}.weight"] = np.asarray(node["scale"])
    tw[f"{name}.bias"] = np.asarray(node["bias"])


def _double_conv_out(tw: TorchState, base: str, pnode: Dict[str, Any],
                     snode: Optional[Dict[str, Any]]) -> None:
    """{base}.double_conv.{0,1,3,4}: conv, BN, conv, BN."""
    snode = snode or {}
    _conv_out(tw, f"{base}.double_conv.0", pnode["Conv_0"])
    _bn_out(tw, f"{base}.double_conv.1", pnode["BatchNorm_0"], snode.get("BatchNorm_0"))
    _conv_out(tw, f"{base}.double_conv.3", pnode["Conv_1"])
    _bn_out(tw, f"{base}.double_conv.4", pnode["BatchNorm_1"], snode.get("BatchNorm_1"))


def _calayer_out(tw: TorchState, base: str, node: Dict[str, Any]) -> None:
    _conv_out(tw, f"{base}.conv_du.0", node["Conv_0"])
    _conv_out(tw, f"{base}.conv_du.2", node["Conv_1"])


def _export_upsampler(tw: TorchState, ups: Dict[str, Any], scale: int,
                      base: str = "tail.0") -> None:
    """The reference upsampler is nn.Sequential(conv, PixelShuffle[, conv,
    PixelShuffle]): conv indices 0, 2 for ×4."""
    nstages = len([k for k in ups if k.startswith("Conv_")])
    assert scale in (2, 3, 4) and nstages >= 1
    for i in range(nstages):
        _conv_out(tw, f"{base}.{2 * i}", ups[f"Conv_{i}"])


def rcan_params_from_fused(params: Dict[str, Any], nlayers: int,
                           nblocks: int) -> Dict[str, Any]:
    """A JAX fused RCAN tree (``FusedResidualGroup_{g}``: w1, b1, w2, b2, wd,
    bd, wu, bu stacked over the RCABs; wg, bg) → the unfused tree
    (``ResidualGroup_{g}``), everything else shared."""
    out = {k: v for k, v in params.items()
           if not k.startswith("FusedResidualGroup_")}
    conv = lambda k, b: {"Conv_0": {"kernel": np.asarray(k), "bias": np.asarray(b)}}
    for g in range(nlayers):
        f = {k: np.asarray(v) for k, v in params[f"FusedResidualGroup_{g}"].items()}
        group: Dict[str, Any] = {}
        for b in range(nblocks):
            group[f"RCAB_{b}"] = {
                "Conv_0": conv(f["w1"][b], f["b1"][b, 0]),
                "Conv_1": conv(f["w2"][b], f["b2"][b, 0]),
                "CALayer_0": {"Conv_0": conv(f["wd"][b], f["bd"][b, 0]),
                              "Conv_1": conv(f["wu"][b], f["bu"][b, 0])},
            }
        group["Conv_0"] = conv(f["wg"], f["bg"][0])
        out[f"ResidualGroup_{g}"] = group
    return out


def export_rcan(params: Dict[str, Any], nlayers: int, nblocks: int,
                scale: int = 4) -> TorchState:
    """flax RCAN params (unfused, unpacked tree, or a ``model.fused`` tree)
    → reference rcan/network.py state dict."""
    if any(k.startswith("FusedResidualGroup_") for k in params):
        params = rcan_params_from_fused(params, nlayers, nblocks)
    tw: TorchState = {}
    _conv_out(tw, "head.0", params["Conv_0"])
    for g in range(nlayers):
        group = params[f"ResidualGroup_{g}"]
        for b in range(nblocks):
            rcab = group[f"RCAB_{b}"]
            base = f"body.{g}.body.{b}"
            _conv_out(tw, f"{base}.body.0", rcab["Conv_0"])
            _conv_out(tw, f"{base}.body.2", rcab["Conv_1"])
            _calayer_out(tw, f"{base}.body.3", rcab["CALayer_0"])
        _conv_out(tw, f"body.{g}.body.{nblocks}", group["Conv_0"])
    _conv_out(tw, f"body.{nlayers}", params["Conv_1"])
    _export_upsampler(tw, params["SPUpsample_0"], scale)
    _conv_out(tw, "tail.1", params["Conv_2"])
    return tw


def export_edsr(params: Dict[str, Any], nlayers: int,
                scale: int = 4) -> TorchState:
    """flax EDSR params → reference edsr/network.py state dict."""
    tw: TorchState = {}
    _conv_out(tw, "head.0", params["Conv_0"])
    for i in range(nlayers):
        rb = params[f"ResBlock_{i}"]
        _conv_out(tw, f"body.{i}.body.0", rb["Conv_0"])
        _conv_out(tw, f"body.{i}.body.2", rb["Conv_1"])
    _conv_out(tw, f"body.{nlayers}", params["Conv_1"])
    _export_upsampler(tw, params["SPUpsample_0"], scale)
    _conv_out(tw, "tail.1", params["Conv_2"])
    return tw


def export_vdsr(params: Dict[str, Any], nlayers: int) -> TorchState:
    """flax VDSR params → reference vdsr/network.py state dict
    (body.{i}.0 conv stack; batch_norm=False path). Inverse of
    torch_import.import_vdsr."""
    tw: TorchState = {}
    for i in range(nlayers):
        _conv_out(tw, f"body.{i}.0", params[f"BasicBlock_{i}"]["Conv_0"])
    return tw


def export_lapsrn(variables: Dict[str, Any], nstages: int) -> TorchState:
    """Inverse of torch_import.import_lapsrn (lapsrn/network.py: inc
    DoubleConv, per-stage ConvDownscale + 1×1 crossscale convs)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    tw: TorchState = {}
    _double_conv_out(tw, "inc", params["DoubleConv_0"], stats.get("DoubleConv_0"))
    for i in range(nstages):
        stage = params[f"ConvUpStage_{i}"]
        sstats = stats.get(f"ConvUpStage_{i}", {})
        _convT_out(tw, f"downscale.{i}.downscale.0", stage["ConvTranspose_0"])
        _double_conv_out(tw, f"downscale.{i}.downscale.1",
                         stage["DoubleConv_0"], sstats.get("DoubleConv_0"))
        _conv_out(tw, f"crossscale.{i}.conv", params[f"Conv_{i}"])
    return tw


def _unet_core_out(tw: TorchState, base: str, pnode: Dict[str, Any],
                   snode: Optional[Dict[str, Any]], depth: int) -> None:
    """Inverse of torch_import._unet_core (common/unet.py UNet)."""
    snode = snode or {}
    for il in range(depth):
        _double_conv_out(tw, f"{base}.downscale.{il}.maxpool_conv.1",
                         pnode[f"DoubleConv_{il}"], snode.get(f"DoubleConv_{il}"))
    for il in range(depth):
        _convT_out(tw, f"{base}.upscale.{il}.up", pnode[f"ConvTranspose_{il}"])
        _double_conv_out(tw, f"{base}.upscale.{il}.conv",
                         pnode[f"DoubleConv_{depth + il}"],
                         snode.get(f"DoubleConv_{depth + il}"))


def export_mscnn(variables: Dict[str, Any], nstages: int,
                 unet_depth: int) -> TorchState:
    """Inverse of torch_import.import_mscnn (lapsrn pyramid + optional UNet
    feature stage)."""
    tw = export_lapsrn(variables, nstages)
    if unet_depth > 0:
        _unet_core_out(tw, "unet", variables["params"]["UNetCore_0"],
                       variables.get("batch_stats", {}).get("UNetCore_0"),
                       unet_depth)
    return tw


def export_unet(variables: Dict[str, Any], depth: int, nups: int) -> TorchState:
    """Inverse of torch_import.import_unet (unet/network.py UNetSR:
    workflow.{0:stem,1:core,2:ups,3:out})."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    tw: TorchState = {}
    _double_conv_out(tw, "workflow.0", params["DoubleConv_0"], stats.get("DoubleConv_0"))
    _unet_core_out(tw, "workflow.1", params["UNetCore_0"], stats.get("UNetCore_0"), depth)
    for i in range(nups):
        _convT_out(tw, f"workflow.2.ups{i}.up", params[f"ConvTranspose_{i}"])
        _double_conv_out(tw, f"workflow.2.ups{i}.conv",
                         params[f"DoubleConv_{i + 1}"],
                         stats.get(f"DoubleConv_{i + 1}"))
    _conv_out(tw, "workflow.3.conv", params["Conv_0"])
    return tw


def export_dbpn(params: Dict[str, Any], depth: int) -> TorchState:
    """Inverse of torch_import.import_dbpn (dbpn/network.py: initial convs +
    interleaved up/down DenseProjections + reconstruction)."""
    tw: TorchState = {}

    def proj_out(base: str, node: Dict[str, Any], transposed: bool) -> None:
        if transposed:
            _convT_out(tw, f"{base}.0", node["ConvTranspose_0"])
        else:
            _conv_out(tw, f"{base}.0", node["Conv_0"])
        _prelu_out(tw, f"{base}.1", node["PReLU_0"])

    def dense_projection_out(base: str, node: Dict[str, Any], up: bool,
                             bottleneck: bool) -> None:
        if bottleneck:
            _conv_out(tw, f"{base}.bottleneck.0", node["Conv_0"])
            _prelu_out(tw, f"{base}.bottleneck.1", node["PReLU_0"])
        proj_out(f"{base}.conv_1", node["_Proj_0"], up)
        proj_out(f"{base}.conv_2", node["_Proj_1"], not up)
        proj_out(f"{base}.conv_3", node["_Proj_2"], up)

    _conv_out(tw, "initial.0", params["Conv_0"])
    _prelu_out(tw, "initial.1", params["PReLU_0"])
    _conv_out(tw, "initial.2", params["Conv_1"])
    _prelu_out(tw, "initial.3", params["PReLU_1"])
    _conv_out(tw, "reconstruction.0", params["Conv_2"])
    idx = 0
    for i in range(depth - 1):
        dense_projection_out(f"upmodules.{i}", params[f"DenseProjection_{idx}"],
                             True, i > 1)
        idx += 1
        dense_projection_out(f"downmodules.{i}", params[f"DenseProjection_{idx}"],
                             False, i != 0)
        idx += 1
    dense_projection_out(f"upmodules.{depth - 1}", params[f"DenseProjection_{idx}"],
                         True, depth - 1 > 1)
    return tw


def export_latticenet(params: Dict[str, Any]) -> TorchState:
    """Inverse of torch_import.import_latticenet (latticenet/network.py:
    stem convs, 4 LatticeBlocks, 6 TDM 1×1 convs, tail convs)."""
    tw: TorchState = {}

    def cc_out(base: str, node: Dict[str, Any]) -> None:
        _conv_out(tw, f"{base}.conv_mean.0", node["Conv_0"])
        _conv_out(tw, f"{base}.conv_mean.2", node["Conv_1"])
        _conv_out(tw, f"{base}.conv_std.0", node["Conv_2"])
        _conv_out(tw, f"{base}.conv_std.2", node["Conv_3"])

    def conv_block3_out(base: str, node: Dict[str, Any]) -> None:
        for j in range(3):
            _conv_out(tw, f"{base}.{2 * j}", node[f"Conv_{j}"])

    _conv_out(tw, "conv1", params["Conv_0"])
    _conv_out(tw, "conv2", params["Conv_1"])
    _conv_out(tw, "tail.0", params["Conv_2"])
    _conv_out(tw, "tail.1", params["Conv_3"])
    for b in range(4):
        base = f"body_unit{b + 1}"
        lb = params[f"LatticeBlock_{b}"]
        conv_block3_out(f"{base}.conv_block0", lb["_ConvBlock3_0"])
        cc_out(f"{base}.fea_ca1", lb["CC_0"])
        cc_out(f"{base}.x_ca1", lb["CC_1"])
        conv_block3_out(f"{base}.conv_block1", lb["_ConvBlock3_1"])
        cc_out(f"{base}.fea_ca2", lb["CC_2"])
        cc_out(f"{base}.x_ca2", lb["CC_3"])
        _conv_out(tw, f"{base}.compress", lb["Conv_0"])
    for i, tname in enumerate(["T_tdm1", "L_tdm1", "T_tdm2", "L_tdm2",
                               "T_tdm3", "L_tdm3"]):
        _conv_out(tw, f"{tname}.0", params[f"_TDM_{i}"]["Conv_0"])
    return tw


def export_srdn(variables: Dict[str, Any], nlayers: int, nups: int) -> TorchState:
    """Inverse of torch_import.import_srdn (srdn/network.py: stem, BN
    residuals, BN global residual, 'replicate' upsampling, output conv)."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    tw: TorchState = {}
    _conv_out(tw, "features.0", params["Conv_0"])
    _prelu_out(tw, "features.1", params["PReLU_0"])
    _conv_out(tw, "global_residual.0", params["Conv_1"])
    _bn_out(tw, "global_residual.1", params["BatchNorm_0"], stats.get("BatchNorm_0"))
    _conv_out(tw, "result", params["Conv_2"])
    for i in range(nlayers):
        base = f"residuals.Residual-{i}.rnet"
        res = params[f"BNResidual_{i}"]
        rstats = stats.get(f"BNResidual_{i}", {})
        _conv_out(tw, f"{base}.0", res["Conv_0"])
        _bn_out(tw, f"{base}.1", res["BatchNorm_0"], rstats.get("BatchNorm_0"))
        _prelu_out(tw, f"{base}.2", res["PReLU_0"])
        _conv_out(tw, f"{base}.3", res["Conv_1"])
        _bn_out(tw, f"{base}.4", res["BatchNorm_1"], rstats.get("BatchNorm_1"))
    for i in range(nups):
        ups = params[f"UpsampleStage_{i}"]
        _conv_out(tw, f"upscaling.{i}.usnet.0", ups["Conv_0"])
        _prelu_out(tw, f"upscaling.{i}.usnet.2", ups["PReLU_0"])
    return tw


def export_esrt(params: Dict[str, Any], nlayers: int, scale: int) -> TorchState:
    """Inverse of torch_import.import_esrt (esrt/network.py +
    common/transformer.py; plain convs — the reference's weight_norm lambdas
    are never applied, PARITY.md bug 6)."""
    tw: TorchState = {}

    def one_conv_out(base: str, node: Dict[str, Any]) -> None:
        _conv_out(tw, f"{base}.conv", node["Conv_0"])
        _prelu_out(tw, f"{base}.relu", node["PReLU_0"])
        _conv_out(tw, f"{base}.conv1", node["Conv_1"])
        _scale_out(tw, f"{base}.weight1", node["Scale_0"])
        _scale_out(tw, f"{base}.weight2", node["Scale_1"])

    def one_module_out(base: str, node: Dict[str, Any]) -> None:
        one_conv_out(f"{base}.layer1", node["OneConv_0"])
        one_conv_out(f"{base}.layer2", node["OneConv_1"])
        # one_module.weight1 is a DEAD parameter in the reference (init
        # Scale(1), never used in forward — esrt/network.py:117,123-128);
        # our flax module has no counterpart, but strict load needs the key
        tw[f"{base}.weight1.scale"] = np.asarray([1.0], np.float32)
        _scale_out(tw, f"{base}.weight2", node["Scale_0"])
        _scale_out(tw, f"{base}.weight3", node["Scale_1"])
        _conv_out(tw, f"{base}.alise.conv", node["Conv_0"])
        _calayer_out(tw, f"{base}.atten", node["CALayer_0"])
        _conv_out(tw, f"{base}.layer4.conv", node["Conv_1"])
        _scale_out(tw, f"{base}.weight4", node["Scale_2"])
        _scale_out(tw, f"{base}.weight5", node["Scale_3"])

    def updown_out(base: str, node: Dict[str, Any]) -> None:
        one_module_out(f"{base}.encoder", node["OneModule_0"])
        one_module_out(f"{base}.decoder_low", node["OneModule_1"])
        one_module_out(f"{base}.decoder_high", node["OneModule_2"])
        one_module_out(f"{base}.alise", node["OneModule_3"])
        _conv_out(tw, f"{base}.alise2.conv", node["Conv_0"])
        _calayer_out(tw, f"{base}.att", node["CALayer_0"])

    def mla_out(base: str, node: Dict[str, Any]) -> None:
        _ln_out(tw, f"{base}.norm1", node["LayerNorm_0"])
        att = node["EffAttention_0"]
        _dense_out(tw, f"{base}.atten.reduce", att["Dense_0"])
        _dense_out(tw, f"{base}.atten.qkv", att["Dense_1"])
        _dense_out(tw, f"{base}.atten.proj", att["Dense_2"])
        _ln_out(tw, f"{base}.norm2", node["LayerNorm_1"])
        _dense_out(tw, f"{base}.mlp.fc1", node["Dense_0"])
        _dense_out(tw, f"{base}.mlp.fc2", node["Dense_1"])

    _conv_out(tw, "head.0", params["Conv_0"])
    for i in range(nlayers):
        base = f"body.{i}"
        un = params[f"Un_{i}"]
        updown_out(f"{base}.encoder1", un["Updownblock_0"])
        updown_out(f"{base}.encoder2", un["Updownblock_1"])
        updown_out(f"{base}.encoder3", un["Updownblock_2"])
        _conv_out(tw, f"{base}.reduce", un["Conv_0"])
        mla_out(f"{base}.attention", un["MLABlock_0"])
        _conv_out(tw, f"{base}.alise", un["Conv_1"])
        _scale_out(tw, f"{base}.weight1", un["Scale_0"])
        _scale_out(tw, f"{base}.weight2", un["Scale_1"])
    _conv_out(tw, "reduce", params["Conv_1"])
    _export_upsampler(tw, params["SPUpsample_0"], scale, "tail.0")
    _conv_out(tw, "tail.1", params["Conv_2"])
    _export_upsampler(tw, params["SPUpsample_1"], scale, "up.0")
    _conv_out(tw, "up.1.conv", params["Conv_3"])
    return tw


def export_swinir(params: Dict[str, Any], nlayers: int, nblocks: int,
                  scale: int = 4) -> TorchState:
    """flax SwinIR params (sres_tpu/models/swinir.py; either attention
    module) → the public SwinIR's state dict names. JAX tree: ``Conv_0``
    (head), ``SwinBlock_{g·nblocks+b}``, ``Conv_{1+g}`` (group convs),
    ``Conv_{nlayers+1}`` (body), ``SPUpsample_0``, ``Conv_{nlayers+2}``
    (tail). The fused attention holds wqkv (C, 3C), bqkv (1, 3C), wo (C, C),
    bo (1, C) and rel_bias; the unfused one Dense_0 (qkv), Dense_1 (proj)
    and rel_bias."""
    tw: TorchState = {}
    _conv_out(tw, "conv_first", params["Conv_0"])
    for g in range(nlayers):
        for b in range(nblocks):
            blk = params[f"SwinBlock_{g * nblocks + b}"]
            base = f"layers.{g}.residual_group.blocks.{b}"
            for i, norm in enumerate(("norm1", "norm2")):
                tw[f"{base}.{norm}.weight"] = np.asarray(blk[f"LayerNorm_{i}"]["scale"])
                tw[f"{base}.{norm}.bias"] = np.asarray(blk[f"LayerNorm_{i}"]["bias"])
            if "FusedWindowAttention_0" in blk:
                a = blk["FusedWindowAttention_0"]
                tw[f"{base}.attn.qkv.weight"] = np.asarray(a["wqkv"]).T
                tw[f"{base}.attn.qkv.bias"] = np.asarray(a["bqkv"]).reshape(-1)
                tw[f"{base}.attn.proj.weight"] = np.asarray(a["wo"]).T
                tw[f"{base}.attn.proj.bias"] = np.asarray(a["bo"]).reshape(-1)
            else:
                a = blk["WindowAttention_0"]
                _dense_out(tw, f"{base}.attn.qkv", a["Dense_0"])
                _dense_out(tw, f"{base}.attn.proj", a["Dense_1"])
            tw[f"{base}.attn.relative_position_bias_table"] = np.asarray(a["rel_bias"])
            _dense_out(tw, f"{base}.mlp.fc1", blk["Dense_0"])
            _dense_out(tw, f"{base}.mlp.fc2", blk["Dense_1"])
        _conv_out(tw, f"layers.{g}.conv", params[f"Conv_{1 + g}"])
    _conv_out(tw, "conv_after_body", params[f"Conv_{nlayers + 1}"])
    _export_upsampler(tw, params["SPUpsample_0"], scale, base="upsample")
    _conv_out(tw, "conv_last", params[f"Conv_{nlayers + 2}"])
    return tw


def export_variables(name: str, variables: Dict[str, Any],
                     model_cfg: Mapping) -> TorchState:
    """flax variables ({'params': .., ['batch_stats': ..]}) → reference torch
    state dict, for each of the eleven architectures."""
    mc = model_cfg
    params = variables["params"]
    nups = len(list(mc.get("downscale_factors", [2, 2])))
    scale = int(np.prod(list(mc.get("downscale_factors", [2, 2]))))
    if name == "rcan":
        return export_rcan(params, mc["nlayers"], mc["nblocks"], scale)
    if name == "edsr":
        return export_edsr(params, mc["nlayers"], scale)
    if name == "swinir":   # nblocks defaults as in sres_tpu/models/swinir.py:207
        return export_swinir(params, mc["nlayers"], mc.get("nblocks", 2), scale)
    if name == "vdsr":
        return export_vdsr(params, mc["nlayers"])
    if name == "lapsrn":
        return export_lapsrn(variables, nups)
    if name == "mscnn":
        return export_mscnn(variables, nups, mc.get("nlayers", 0))
    if name == "unet":
        return export_unet(variables, mc["nlayers"], nups)
    if name == "dbpn":
        return export_dbpn(params, mc.get("depth", 2))
    if name == "latticenet":
        return export_latticenet(params)
    if name == "srdn":
        return export_srdn(variables, mc["nlayers"], nups)
    if name == "esrt":
        return export_esrt(params, mc["nlayers"], scale)
    raise KeyError(f"no weight export for '{name}'; available: ['dbpn', 'edsr', "
                   "'esrt', 'lapsrn', 'latticenet', 'mscnn', 'rcan', 'srdn', "
                   "'swinir', 'unet', 'vdsr']")


def state_dict_from_jax(variables_np: Dict[str, Any],
                        model_cfg: Mapping) -> Dict[str, torch.Tensor]:
    """{'params': ..., ['batch_stats': ...]} of numpy arrays → state dict."""
    tw = export_variables(model_cfg["name"], variables_np, model_cfg)
    return {k: torch.from_numpy(np.array(v)) for k, v in tw.items()}
