"""On-device tile-grid assembly for full-region inference (counterpart of
sres_tpu/ops/assemble.py).

The reference assembles region images on the host with np.block
(sres/controller/dual_trainer.py:449-480). Region inference here scatters
the padded SR tile batch into the region mosaic on the device — NaN-filled
for dropped (land) tiles — so only the finished image crosses to the host
(BASELINE.json config #5). The scatter is one ``index_copy_`` into a
NaN-filled slot tensor: a plain large copy, which a PyTorch call does at
the memory's rate, so no kernel of the port's own is written for it.
"""
from __future__ import annotations

from typing import Dict

import torch


def assemble_tiles(tiles: torch.Tensor, tile_ids: torch.Tensor,
                   grid_shape: Dict[str, int], weight: torch.Tensor) -> torch.Tensor:
    """(N, ty, tx) tiles + flat grid ids (+ 0/1 validity weights for padding)
    → (gy*ty, gx*tx) mosaic with NaN holes, on the tiles' device.

    Padding (weight == 0) goes to a trash slot past the grid, so no shape
    depends on the data; the trash slot is dropped."""
    gy, gx = int(grid_shape["y"]), int(grid_shape["x"])
    n, ty, tx = tiles.shape
    nslots = gy * gx
    slots = tiles.new_full((nslots + 1, ty, tx), float("nan"))
    idx = torch.where(weight > 0, tile_ids.to(torch.int64),
                      torch.full_like(tile_ids, nslots, dtype=torch.int64))
    slots.index_copy_(0, idx, tiles)
    grid = slots[:nslots].reshape(gy, gx, ty, tx)
    return grid.permute(0, 2, 1, 3).reshape(gy * ty, gx * tx)
