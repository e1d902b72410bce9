"""Weight transfer from the JAX package: flax variables (as numpy arrays) →
a torch state dict in the reference's naming, which the port's modules
load with ``strict=True``.

The port keeps its own copy of the RCAN and EDSR parts of the JAX package's
exporter (sres_tpu/util/torch_export.py:27-143 and the ``rcan`` and
``edsr`` branches of ``export_variables`` :380-391), and a numpy copy of
``sres_tpu.models.fused.rcan_params_from_fused`` (:129-147), so that a JAX
``model.fused`` tree (``FusedResidualGroup_{g}`` stacks) exports to the same
names as an unfused one; it imports nothing of the JAX package; SwinIR's (``export_swinir``), which the JAX package lacks, maps
both of its attention trees onto the public SwinIR's names. Layout: flax
conv kernels (kh, kw, Cin, Cout) → torch (Cout, Cin, kh, kw), Dense kernels
(in, out) → Linear weights (out, in). The other architectures are not
ported.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

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


def _dense_out(tw: TorchState, name: str, node: Dict[str, Any]) -> None:
    tw[f"{name}.weight"] = np.asarray(node["kernel"]).T
    tw[f"{name}.bias"] = np.asarray(node["bias"])


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
    state dict. ``rcan``, ``swinir`` and ``edsr`` are ported."""
    scale = int(np.prod(list(model_cfg.get("downscale_factors", [2, 2]))))
    if name == "rcan":
        return export_rcan(variables["params"], model_cfg["nlayers"],
                           model_cfg["nblocks"], scale)
    if name == "edsr":
        return export_edsr(variables["params"], model_cfg["nlayers"], scale)
    if name == "swinir":   # nblocks defaults as in sres_tpu/models/swinir.py:207
        return export_swinir(variables["params"], model_cfg["nlayers"],
                             model_cfg.get("nblocks", 2), scale)
    raise NotImplementedError(
        f"weight export for '{name}' is not ported yet (ROADMAP Queue 1 "
        "item 8); available: ['edsr', 'rcan', 'swinir']")


def state_dict_from_jax(variables_np: Dict[str, Any],
                        model_cfg: Mapping) -> Dict[str, torch.Tensor]:
    """{'params': ..., ['batch_stats': ...]} of numpy arrays → state dict."""
    tw = export_variables(model_cfg["name"], variables_np, model_cfg)
    return {k: torch.from_numpy(np.array(v)) for k, v in tw.items()}
