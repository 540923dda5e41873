"""Volume compositing and the ray box in plain PyTorch for the
benchmark's reference; ``composite`` is differentiated by autograd."""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


def exclusive_cumprod(x: torch.Tensor) -> torch.Tensor:
    """T_i = prod_{j<i} x_j along the last axis."""
    c = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(x[..., :1]), c[..., :-1]], dim=-1)


class CompositeOut(NamedTuple):
    weights: Optional[torch.Tensor]   # [N, K]
    weights_sum: torch.Tensor         # [N]
    depth: torch.Tensor               # [N]
    rgb: torch.Tensor                 # [N, 3]


def composite(sigmas: torch.Tensor, rgbs: torch.Tensor, deltas: torch.Tensor,
              ts: Optional[torch.Tensor] = None,
              T_thresh: float = 0.0) -> CompositeOut:
    """alpha_i = 1 - exp(-sigma_i delta_i); weights = alpha * T with T the
    exclusive product of (1 - alpha + 1e-15); T_thresh > 0 zeroes every
    weight whose T is at or below the threshold (raymarching.cu:557 as a
    mask)."""
    sigmas = sigmas.float()
    deltas = deltas.float()
    alphas = 1.0 - torch.exp(-sigmas * deltas)
    trans = exclusive_cumprod(1.0 - alphas + 1e-15)
    weights = alphas * trans
    if T_thresh > 0.0:
        weights = torch.where(trans > T_thresh, weights,
                              torch.zeros_like(weights))
    if ts is None:
        ts = torch.cumsum(deltas, dim=-1)
    return CompositeOut(weights, weights.sum(-1),
                        (weights * ts.float()).sum(-1),
                        (weights[..., None] * rgbs.float()).sum(-2))


def near_far_from_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor,
                       aabb: torch.Tensor, min_near: float = 0.05
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab test (raymarching.cu:92-156): misses get near = far = 1e9, then
    near is clamped to min_near."""
    tiny = torch.where(rays_d >= 0, torch.full_like(rays_d, 1e-15),
                       torch.full_like(rays_d, -1e-15))
    rdir = 1.0 / torch.where(rays_d.abs() < 1e-15, tiny, rays_d)
    t0 = (aabb[:3] - rays_o) * rdir
    t1 = (aabb[3:] - rays_o) * rdir
    near = torch.minimum(t0, t1).amax(-1)
    far = torch.maximum(t0, t1).amin(-1)
    miss = far < near
    big = torch.full_like(near, 1e9)
    near = torch.where(miss, big, near)
    far = torch.where(miss, big, far)
    return torch.clamp(near, min=min_near), far


