"""Model factory (counterpart of sres_tpu/models/registry.py): model config
→ ``nn.Module``. Only ``rcan`` is ported; every other name raises.

``build_model`` returns an f32-parameter module on the CPU whose forward
computes in the dtype of ``precision``; move it with ``.to(device)``. With
``seed`` the parameters are drawn from torch's default conv init by one
seeded ``torch.Generator`` (reproducible across runs and machines).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional

from sres_tpu_torch.device import compute_dtype

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


def build_model(model_cfg: Mapping, nchannels_in: int, nchannels_out: int,
                precision: str = "bf16", seed: Optional[int] = None):
    name = model_cfg["name"]
    if name != "rcan":
        raise NotImplementedError(
            f"model '{name}' is not ported yet (ROADMAP Queue 1 item 8); "
            "available: ['rcan']")
    from sres_tpu_torch.models import rcan
    from sres_tpu_torch.models.layers import init_torch_default
    model = rcan.build(model_cfg, nchannels_in, nchannels_out,
                       dtype=compute_dtype(precision))
    if seed is not None:
        init_torch_default(model, seed)
    return model
