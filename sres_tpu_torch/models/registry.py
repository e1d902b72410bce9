"""Model factory (counterpart of sres_tpu/models/registry.py): model config
→ ``nn.Module``, for all eleven names of the JAX registry (rcan, edsr,
vdsr, lapsrn, mscnn, srdn, unet, dbpn, latticenet, esrt, swinir); any
other name raises ``KeyError`` naming them.

``build_model`` returns an f32-parameter module on ``device`` (the card by
default; ``device="cpu"`` only when asked, and an error when the card is
asked for and absent) whose forward computes in the dtype of
``precision``. With ``seed`` the parameters are drawn from torch's default
conv and linear init (SwinIR's bias tables from a truncated normal) by one
seeded ``torch.Generator`` on the CPU (reproducible across runs and
machines), then moved.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

from sres_tpu_torch.device import compute_dtype, resolve_device

COMMON_PARMS: Dict[str, Any] = dict(
    nchannels_in=1,
    nchannels_out=1,
    nfeatures=64,
    kernel_size=3,
    nlayers=16,
    downscale_factors=[2, 2],
    bias=True,
    batch_norm=False,
    res_scale=1.0,
    ups_mode="bicubic",
)


def resolve_parms(model_cfg: Mapping, extra_defaults: Optional[Dict[str, Any]] = None,
                  **overrides: Any) -> Dict[str, Any]:
    """Merge the model config over COMMON_PARMS (+ per-model defaults)."""
    parms = {k: model_cfg.get(k, v) for k, v in COMMON_PARMS.items()}
    for k, v in (extra_defaults or {}).items():
        parms[k] = model_cfg.get(k, v)
    parms.update(overrides)
    parms["downscale_factors"] = list(parms["downscale_factors"])
    parms["scale"] = math.prod(parms["downscale_factors"])
    return parms


def model_names() -> Dict[str, Any]:
    from sres_tpu_torch.models import (dbpn, edsr, esrt, lapsrn, latticenet, mscnn,
                                       rcan, srdn, swinir, unet, vdsr)
    return {
        "rcan": rcan.build, "edsr": edsr.build, "vdsr": vdsr.build,
        "lapsrn": lapsrn.build, "mscnn": mscnn.build, "srdn": srdn.build,
        "unet": unet.build, "dbpn": dbpn.build, "latticenet": latticenet.build,
        "esrt": esrt.build, "swinir": swinir.build,
    }


def build_model(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
                precision: str = "bf16", seed: Optional[int] = None,
                device: str = "cuda", temporal_features=None):
    """``temporal_features`` (the dataset's (T, n) features, or n) sizes a
    UNet's bottleneck reservation when ``use_temporal_features`` is set;
    every other model ignores it, as in JAX."""
    dev = resolve_device(device)
    name = model_cfg["name"]
    from sres_tpu_torch.models.layers import init_torch_default
    builders = model_names()
    if name not in builders:
        raise KeyError(f"Unknown model '{name}'; available: {sorted(builders)}")
    kw = {"temporal_features": temporal_features} if name == "unet" else {}
    model = builders[name](model_cfg, nchannels_in, nchannels_out,
                           dtype=compute_dtype(precision), **kw)
    if seed is not None:
        init_torch_default(model, seed)
    return model.to(dev)
