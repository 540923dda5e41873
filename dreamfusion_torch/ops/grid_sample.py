"""Differentiable trilinear 3-D grid sampling, align_corners=True
(counterpart of dreamfusion_tpu/ops/grid_sample.py).

Replaces torch's F.grid_sample as DVGO's grid sampler uses it
(frameworks/nerf/modules/dvgo_coarse.py:67-73), written out as a gather of
the 8 corners and a blend, like the JAX module: the editing field's normal
differentiates the sample with respect to the position, which the
reference had to patch in (nerf/network.py:232-233). The JAX module reaches
no Pallas kernel, so this one holds none.

Convention: ``grid_sample_3d(grid [C, X, Y, Z], xyz01 [..., 3]) -> [..., C]``
with xyz01[..., i] in [0, 1] indexing axis i at xyz01 * (S_i - 1).
Out-of-range coordinates clamp to the border (DVGO masks out-of-box points
before sampling).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_3d(grid: torch.Tensor, xyz01: torch.Tensor,
                   differentiable: bool = True) -> torch.Tensor:
    """grid [C, X, Y, Z]; xyz01 [..., 3] in [0, 1] -> [..., C].

    differentiable=True keeps d(out)/d(xyz01) (the editing field's autograd
    normal needs it); False detaches the position, so only the grid gets a
    gradient."""
    C = grid.shape[0]
    sizes = grid.shape[1:]
    prefix = xyz01.shape[:-1]
    if not differentiable:
        xyz01 = xyz01.detach()
    x = xyz01.reshape(-1, 3).float().t()                       # [3, B]
    hi = torch.tensor([s - 1.0 for s in sizes], device=x.device)[:, None]
    pos = torch.minimum(torch.clamp(x * hi, min=0.0), hi)
    p0 = torch.floor(pos).detach()
    frac = pos - p0
    p0 = p0.long()
    strides = (sizes[1] * sizes[2], sizes[2], 1)

    idx_corners, w_corners = [], []
    for corner in range(8):
        w = torch.ones_like(frac[0])
        idx = torch.zeros_like(p0[0])
        for d in range(3):
            if (corner >> d) & 1:
                w = w * frac[d]
                idx = idx + torch.clamp(p0[d] + 1, max=sizes[d] - 1) * strides[d]
            else:
                w = w * (1.0 - frac[d])
                idx = idx + p0[d] * strides[d]
        idx_corners.append(idx)
        w_corners.append(w)
    idx8, w8 = torch.stack(idx_corners), torch.stack(w_corners)   # [8, B]

    flat = grid.reshape(C, -1).t()                                # [XYZ, C]
    out = (w8[..., None] * flat[idx8].float()).sum(0)
    return out.reshape(*prefix, C)


def resize_grid_trilinear(grid: torch.Tensor, new_size) -> torch.Tensor:
    """Trilinear re-interpolation of a [C, X, Y, Z] grid to (X', Y', Z'),
    align_corners=True: DVGO's progressive grid scaling
    (frameworks/nerf/modules/dvgo_fine.py:35-42)."""
    nx, ny, nz = new_size
    lin = [torch.linspace(0.0, 1.0, n, device=grid.device)
           for n in (nx, ny, nz)]
    pts = torch.stack(torch.meshgrid(*lin, indexing="ij"), dim=-1)
    out = grid_sample_3d(grid, pts.reshape(-1, 3))                # [n, C]
    return out.t().reshape(grid.shape[0], nx, ny, nz)


def max_pool_3d(grid: torch.Tensor, ks: int = 3) -> torch.Tensor:
    """Same-padded max-pool (stride 1) over the spatial dims of
    [C, X, Y, Z] (MaskCache's F.max_pool3d,
    frameworks/nerf/modules/utils.py:22)."""
    return F.max_pool3d(grid[None], ks, stride=1, padding=ks // 2)[0]
