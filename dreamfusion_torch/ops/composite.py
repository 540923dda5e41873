"""Volume-compositing math, plain PyTorch (counterpart of
dreamfusion_tpu/ops/composite.py).

``composite`` is differentiated by autograd; it is the reference the fused
kernel (ops/fused_composite.py) is held against.
"""

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


def linspace(start: float, stop: float, num: int,
             device: Optional[torch.device] = None) -> torch.Tensor:
    """num evenly spaced f32 values from start to stop, built by the formula
    of jnp.linspace as XLA compiles it on the CPU: start * (1 - s) + stop * s
    with s = i * (1 / (num - 1)), the last value stop itself. The unit grid
    (start 0, stop 1) is then the JAX package's to the bit, where
    torch.linspace differs from it by an ulp at some entries; other grids
    may still differ by an ulp, by XLA's rewrites."""
    start_t = torch.tensor(start, dtype=torch.float32, device=device)
    stop_t = torch.tensor(stop, dtype=torch.float32, device=device)
    if num == 1:
        return start_t[None]
    recip = torch.tensor(1.0, dtype=torch.float32) / (num - 1)
    s = torch.arange(num - 1, dtype=torch.float32, device=device) * recip.to(device)
    return torch.cat([start_t * (1.0 - s) + stop_t * s, stop_t[None]])


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_samples: int,
               det: bool = False, u: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverse-CDF importance sampling of new z values (nerf/renderer.py:
    15-49). bins [N, T] bin centres, weights [N, T-1] -> [N, n_samples].
    det: the fixed grid linspace(0.5 / n, 1 - 0.5 / n, n); otherwise the
    uniform draws u [N, n_samples], drawn from `generator` when absent.
    Computes in float32, or in float64 when the weights are float64 (a
    reference)."""
    weights = weights.to(torch.float64 if weights.dtype == torch.float64
                         else torch.float32) + 1e-5
    pdf = weights / weights.sum(-1, keepdim=True)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)     # [N, T]
    shape = cdf.shape[:-1] + (n_samples,)
    if det:
        u = linspace(0.5 / n_samples, 1.0 - 0.5 / n_samples, n_samples,
                     cdf.device).expand(shape)
    elif u is None:
        u = torch.rand(shape, generator=generator, device=cdf.device)
    u = u.to(cdf.device, cdf.dtype).contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=cdf.shape[-1] - 1)
    cdf_g0 = torch.gather(cdf, -1, below)
    cdf_g1 = torch.gather(cdf, -1, above)
    last = bins.shape[-1] - 1
    bins_g0 = torch.gather(bins, -1, torch.clamp(below, max=last))
    bins_g1 = torch.gather(bins, -1, torch.clamp(above, max=last))
    denom = cdf_g1 - cdf_g0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_g0) / denom
    return bins_g0 + t * (bins_g1 - bins_g0)
