"""Small parity ops (counterpart of dreamfusion_tpu/ops/misc.py).

- sph_from_ray: ray -> background-sphere (u, v) in [-1, 1]
  (reference raymarching/src/raymarching.cu:163-209);
- linear_to_srgb / srgb_to_linear (reference nerf/utils.py:141-148);
- sample_rays_with_error_map: error-map-weighted pixel sampling
  (reference nerf/utils.py:65-88), its draws injectable.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def sph_from_ray(rays_o: torch.Tensor, rays_d: torch.Tensor,
                 radius: float) -> torch.Tensor:
    """Where the rays leave the sphere of `radius`, as equirectangular
    (u, v) in [-1, 1]: u = atan2(x, z) / pi, v = the elevation over pi / 2
    (raymarching.cu:163-209)."""
    b = (rays_o * rays_d).sum(-1)
    c = (rays_o * rays_o).sum(-1) - radius * radius
    t = -b + torch.sqrt(torch.clamp(b * b - c, min=0.0))
    p = rays_o + t[..., None] * rays_d
    u = torch.atan2(p[..., 0], p[..., 2]) / math.pi
    v = torch.atan2(p[..., 1], torch.linalg.norm(p[..., [0, 2]], dim=-1)) \
        / (math.pi / 2)
    return torch.stack([u, v], -1)


def linear_to_srgb(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.0031308, 12.92 * x,
                       1.055 * torch.clamp(x, min=1e-8) ** 0.41666 - 0.055)


def srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x < 0.04045, x / 12.92,
                       (torch.clamp(x + 0.055, min=1e-8) / 1.055) ** 2.4)


def sample_rays_with_error_map(error_map: torch.Tensor, N: int, H: int,
                               W: int, *, cells: Optional[torch.Tensor] = None,
                               jitter: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """N pixel indices drawn from a 128 x 128 error map (nerf/utils.py:
    73-83): a coarse cell by its error weight, then a uniform position in
    the cell. Draws (optional): cells [N] (the coarse cell indices) and
    jitter [2, N] (uniform in [0, 1): rows, then columns). Returns (inds [N]
    into H * W, inds_coarse [N])."""
    dev = error_map.device
    if cells is None:
        p = torch.clamp(error_map.reshape(-1).float(), min=1e-12)
        cells = torch.multinomial(p / p.sum(), N, replacement=True,
                                  generator=generator)
    if jitter is None:
        jitter = torch.rand(2, N, generator=generator, device=dev)
    cells = cells.to(dev).long()
    sx, sy = H / 128.0, W / 128.0
    x = torch.clamp(((cells // 128) * sx + jitter[0] * sx).int(), 0, H - 1)
    y = torch.clamp(((cells % 128) * sy + jitter[1] * sy).int(), 0, W - 1)
    return x.long() * W + y.long(), cells
