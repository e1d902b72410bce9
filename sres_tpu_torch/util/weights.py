"""Weight transfer from the JAX package: flax variables (as numpy arrays) →
a torch state dict in the reference's naming, which the port's modules
load with ``strict=True``.

Uses ``sres_tpu.util.torch_export.export_variables`` — a numpy-only module
of the JAX package, imported at call time so that importing the port never
pulls in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def state_dict_from_jax(variables_np: Dict[str, Any],
                        model_cfg: Mapping) -> Dict[str, torch.Tensor]:
    """{'params': ..., ['batch_stats': ...]} of numpy arrays → state dict."""
    from sres_tpu.util.torch_export import export_variables
    tw = export_variables(model_cfg["name"], variables_np, model_cfg)
    return {k: torch.from_numpy(np.array(v)) for k, v in tw.items()}
