"""DVGO (Direct Voxel Grid Optimization) scene field, the part the editing
path queries (counterpart of dreamfusion_tpu/models/dvgo.py; reference
frameworks/nerf/modules/dvgo_coarse.py, dvgo_fine.py):

- dense voxel grids: density [1, X, Y, Z] and colour / feature k0
  [C, X, Y, Z], trilinearly sampled (ops/grid_sample.py);
- post-activated density: alpha = 1 - exp(-softplus(d + act_shift) *
  interval), act_shift = log(1 / (1 - alpha_init) - 1);
- fine model colour: k0 features + positional and view encodings -> a
  registered rgbnet MLP (models/decoders.py).

The coarse model (k0 as direct colour), DVGO's own renderer (``render``,
``sample_ray``), its training losses, the free-space mask cache and the
progressive grid scaling belong to DVGO pretraining and are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dreamfusion_torch.models.decoders import get_MLP
from dreamfusion_torch.ops.grid_sample import grid_sample_3d


def position_encoding(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """[x, sin(f x), cos(f x)] flattened (modules/utils.py:129-131)."""
    emb = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(emb), torch.cos(emb)], -1)


class DVGOField(nn.Module):
    """One DVGO fine-model scene field."""

    def __init__(self, world_size: Tuple[int, int, int], k0_dim: int = 3,
                 rgbnet_name: str = "resmlp", rgbnet_width: int = 128,
                 rgbnet_depth: int = 3, posbase_pe: int = 5,
                 viewbase_pe: int = 4,
                 xyz_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0),
                 xyz_max: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                 alpha_init: float = 1e-6, stepsize: float = 0.5,
                 voxel_size_ratio: float = 1.0):
        super().__init__()
        self.world_size = tuple(int(s) for s in world_size)
        self.k0_dim = k0_dim
        self.posbase_pe, self.viewbase_pe = posbase_pe, viewbase_pe
        self.xyz_min, self.xyz_max = tuple(xyz_min), tuple(xyz_max)
        self.alpha_init = alpha_init
        self.stepsize = stepsize
        self.voxel_size_ratio = voxel_size_ratio
        X, Y, Z = self.world_size
        self.density = nn.Parameter(torch.empty(1, X, Y, Z))
        self.k0 = nn.Parameter(torch.empty(k0_dim, X, Y, Z))
        self.register_buffer("mins", torch.tensor(self.xyz_min),
                             persistent=False)
        self.register_buffer("maxs", torch.tensor(self.xyz_max),
                             persistent=False)
        dim0 = k0_dim
        if posbase_pe:
            dim0 += 3 + 3 * posbase_pe * 2
        if viewbase_pe:
            dim0 += 3 + 3 * viewbase_pe * 2
        self.rgbnet = get_MLP(rgbnet_name, in_dim=dim0, out_dim=3,
                              width=rgbnet_width, depth=rgbnet_depth,
                              k0_dim=k0_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.density.normal_(generator=generator)
            self.k0.normal_(generator=generator)
        self.rgbnet.reset_parameters(generator)

    @property
    def act_shift(self) -> float:
        return math.log(1.0 / (1.0 - self.alpha_init) - 1.0)

    @property
    def voxel_size(self) -> float:
        ext = [hi - lo for lo, hi in zip(self.xyz_min, self.xyz_max)]
        return sum(e / s for e, s in zip(ext, self.world_size)) / 3.0

    def normalize(self, pts: torch.Tensor) -> torch.Tensor:
        return (pts - self.mins) / (self.maxs - self.mins)

    def sample_density(self, pts: torch.Tensor) -> torch.Tensor:
        return grid_sample_3d(self.density, self.normalize(pts))[..., 0]

    def activate_density(self, density: torch.Tensor,
                         interval: Optional[float] = None) -> torch.Tensor:
        if interval is None:
            interval = self.stepsize * self.voxel_size_ratio
        return 1.0 - torch.exp(-F.softplus(density + self.act_shift) * interval)

    def query_alpha(self, pts: torch.Tensor) -> torch.Tensor:
        return self.activate_density(self.sample_density(pts))

    def query_rgb(self, pts: torch.Tensor,
                  viewdirs: torch.Tensor) -> torch.Tensor:
        k0 = grid_sample_3d(self.k0, self.normalize(pts))
        feats = [k0]
        if self.posbase_pe:
            freqs = torch.exp2(torch.arange(self.posbase_pe, device=pts.device,
                                            dtype=torch.float32))
            feats.append(position_encoding(self.normalize(pts), freqs))
        if self.viewbase_pe:
            freqs = torch.exp2(torch.arange(self.viewbase_pe,
                                            device=pts.device,
                                            dtype=torch.float32))
            feats.append(position_encoding(viewdirs, freqs))
        return torch.sigmoid(self.rgbnet(torch.cat(feats, -1)))
