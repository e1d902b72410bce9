"""Weight transfer from the JAX package: flax variables (as numpy arrays) →
a torch state dict in the reference's naming, which the port's modules
load with ``strict=True``.

The port keeps its own copy of the RCAN part of the JAX package's exporter
(sres_tpu/util/torch_export.py:27-127 and the ``rcan`` branch of
``export_variables`` :380-391), so that it imports nothing of the JAX
package. Layout: flax conv kernels (kh, kw, Cin, Cout) → torch (Cout, Cin,
kh, kw). The other architectures are not ported.
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


def export_rcan(params: Dict[str, Any], nlayers: int, nblocks: int,
                scale: int = 4) -> TorchState:
    """flax RCAN params (unfused, unpacked tree) → reference rcan/network.py
    state dict."""
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


def export_variables(name: str, variables: Dict[str, Any],
                     model_cfg: Mapping) -> TorchState:
    """flax variables ({'params': .., ['batch_stats': ..]}) → reference torch
    state dict. Only ``rcan`` is ported."""
    if name != "rcan":
        raise NotImplementedError(
            f"weight export for '{name}' is not ported yet (ROADMAP Queue 1 "
            "item 8); available: ['rcan']")
    dsf = list(model_cfg.get("downscale_factors", [2, 2]))
    return export_rcan(variables["params"], model_cfg["nlayers"],
                       model_cfg["nblocks"], int(np.prod(dsf)))


def state_dict_from_jax(variables_np: Dict[str, Any],
                        model_cfg: Mapping) -> Dict[str, torch.Tensor]:
    """{'params': ..., ['batch_stats': ...]} of numpy arrays → state dict."""
    tw = export_variables(model_cfg["name"], variables_np, model_cfg)
    return {k: torch.from_numpy(np.array(v)) for k, v in tw.items()}
