"""Trilinear 3-D grid sampling as DVGO samples its voxel grids
(frameworks/nerf/modules/dvgo_coarse.py:67-73): torch's F.grid_sample,
align_corners=True, for the benchmark's reference.

``grid_sample_3d(grid [C, X, Y, Z], xyz01 [..., 3]) -> [..., C]`` with
xyz01[..., i] in [0, 1] indexing axis i at xyz01 * (S_i - 1).
Out-of-range coordinates clamp to the border (DVGO masks out-of-box points
before sampling)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_3d(grid: torch.Tensor, xyz01: torch.Tensor) -> torch.Tensor:
    C, prefix = grid.shape[0], xyz01.shape[:-1]
    # grid_sample's last axis indexes (Z, Y, X) of a [.., X, Y, Z] volume
    ind = xyz01.reshape(1, 1, 1, -1, 3).float().flip(-1) * 2.0 - 1.0
    out = F.grid_sample(grid[None].float(), ind, mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out.reshape(C, -1).t().reshape(*prefix, C)
