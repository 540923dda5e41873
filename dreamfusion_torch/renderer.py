"""Stratified volume renderer, path A (counterpart of
dreamfusion_tpu/renderer.py; reference nerf/renderer.py:301-443, the
non-cuda_ray ``run``).

``render_stratified``: num_steps uniform samples between the box's near and
far (jittered by +-0.5 bin when perturbed), ``upsample_steps`` importance
samples drawn from the coarse pass's detached weights, merged and sorted,
one field evaluation over all of them, compositing with the plain
``ops/composite.composite`` (as the JAX package does on this path), and the
background blend. ``render_rays_chunked`` renders a frame in fixed chunks
of rays.

The field is the FieldFns of models/networks.make_field_fns. Every draw is
injectable, following the JAX key tree ``k_light, k_perturb, k_pdf,
k_smooth = split(k_render, 4)``: light_n [3] (light_d = normalize(rays_o[0]
+ light_n)), perturb_u [N, num_steps], pdf_u [N, upsample_steps] and
smooth_n [N, T, 3] (standard normal); absent draws come from `generator`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from dreamfusion_torch.cameras import safe_normalize
from dreamfusion_torch.models.networks import SHADING_ALBEDO, FieldFns
from dreamfusion_torch.ops.composite import (composite, linspace,
                                             near_far_from_aabb, sample_pdf)


def sample_light_d(rays_o: torch.Tensor,
                   light_n: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """normalize(rays_o[0] + N(0, 1)): a light near the view direction
    (nerf/renderer.py:461-464)."""
    if light_n is None:
        light_n = torch.randn(3, generator=generator, device=rays_o.device)
    return safe_normalize(rays_o[0] + light_n.to(rays_o.device))


def _deltas(z_vals: torch.Tensor, sample_dist: torch.Tensor) -> torch.Tensor:
    d = z_vals[:, 1:] - z_vals[:, :-1]
    return torch.cat([d, sample_dist.expand(d.shape[0], 1)], -1)


def render_stratified(fns: FieldFns, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, *, bound: float = 1.0,
                      min_near: float = 0.1, num_steps: int = 64,
                      upsample_steps: int = 64, bg_radius: float = 1.4,
                      light_d: Optional[torch.Tensor] = None,
                      ambient_ratio: float = 1.0,
                      shading_code: int = SHADING_ALBEDO,
                      bg_color: Optional[torch.Tensor] = None,
                      perturb: bool = False,
                      compute_normal_losses: bool = False,
                      generator: Optional[torch.Generator] = None,
                      light_n: Optional[torch.Tensor] = None,
                      perturb_u: Optional[torch.Tensor] = None,
                      pdf_u: Optional[torch.Tensor] = None,
                      smooth_n: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """Stratified + importance-sampled rendering of N rays [N, 3]
    (renderer.py:44-150). Returns image [N, 3], depth [N] (normalized to
    [0, 1] between near and far), weights_sum [N], mask [N] and, with
    compute_normal_losses, loss_orient (and loss_smooth when fns.normal is
    set)."""
    N, dev = rays_o.shape[0], rays_o.device
    aabb = torch.tensor([-bound] * 3 + [bound] * 3, dtype=torch.float32,
                        device=dev)
    nears, fars = near_far_from_aabb(rays_o, rays_d, aabb, min_near)
    nears, fars = nears[:, None], fars[:, None]
    if light_d is None:
        light_d = sample_light_d(rays_o, light_n, generator)

    z_vals = nears + (fars - nears) * linspace(0.0, 1.0, num_steps, dev)[None]
    sample_dist = (fars - nears) / num_steps
    if perturb:
        if perturb_u is None:
            perturb_u = torch.rand(z_vals.shape, generator=generator,
                                   device=dev)
        z_vals = z_vals + (perturb_u.to(dev) - 0.5) * sample_dist

    def pts(zv):
        p = rays_o[:, None, :] + rays_d[:, None, :] * zv[..., None]
        return torch.clamp(p, -bound, bound)

    if upsample_steps > 0:
        # importance sampling on the coarse pass's detached weights
        # (renderer.py:354-387): nothing of it is differentiated
        with torch.no_grad():
            sigmas = fns.density(pts(z_vals).reshape(-1, 3))["sigma"]
            deltas = _deltas(z_vals, sample_dist)
            coarse = composite(sigmas.reshape(N, num_steps),
                               torch.zeros(N, num_steps, 3, device=dev),
                               deltas)
            z_mid = z_vals[:, :-1] + 0.5 * deltas[:, :-1]
            new_z = sample_pdf(z_mid, coarse.weights[:, 1:-1],
                               upsample_steps, det=not perturb, u=pdf_u,
                               generator=generator)
        z_vals = torch.sort(torch.cat([z_vals, new_z], 1), 1).values
    xyzs = pts(z_vals)

    T = z_vals.shape[1]
    dirs = rays_d[:, None, :].expand(N, T, 3)
    sigma, color, normal = fns.field(xyzs.reshape(-1, 3), dirs.reshape(-1, 3),
                                     light_d, ambient_ratio, shading_code)
    sigma = sigma.reshape(N, T)
    color = color.reshape(N, T, 3)

    deltas = _deltas(z_vals, sample_dist)
    # miss rays have near == far (1e9): the guard keeps their depth 0, not
    # 0 / 0 (renderer.py:114-119)
    ori_z = torch.clamp((z_vals - nears) / torch.clamp(fars - nears, min=1e-6),
                        0.0, 1.0)
    out = composite(sigma, color, deltas, ts=ori_z)

    results: Dict[str, torch.Tensor] = {}
    if compute_normal_losses:
        normal = normal.reshape(N, T, 3)
        # orientation loss on detached weights (renderer.py:402-406)
        w_sg = out.weights.detach()
        loss_orient = w_sg * torch.clamp((normal * dirs).sum(-1), min=0.0) ** 2
        results["loss_orient"] = loss_orient.sum(-1).mean()
        if fns.normal is not None:
            # smoothness under a small jitter (renderer.py:408-411)
            if smooth_n is None:
                smooth_n = torch.randn(xyzs.shape, generator=generator,
                                       device=dev)
            xp = xyzs + smooth_n.to(dev) * 1e-2
            normal_p = fns.normal(xp.reshape(-1, 3)).reshape(N, T, 3)
            results["loss_smooth"] = (normal - normal_p).abs().mean()

    # background blend (renderer.py:424-431)
    if bg_radius > 0 and fns.background is not None:
        bg = fns.background(rays_d)
    elif bg_color is not None:
        bg = bg_color
    else:
        bg = torch.ones(N, 3, device=dev)
    results.update({
        "image": out.rgb + (1.0 - out.weights_sum)[:, None] * bg,
        "depth": out.depth,
        "weights_sum": out.weights_sum,
        "mask": (nears < fars)[:, 0],
    })
    return results


def render_rays_chunked(render_fn: Callable, rays_o: torch.Tensor,
                        rays_d: torch.Tensor, chunk: int = 4096
                        ) -> Dict[str, torch.Tensor]:
    """render_fn(o, d) over chunks of `chunk` rays, the outputs concatenated
    (the reference's staged inference, renderer.py:631-644). The rays are
    padded to a multiple of the chunk as renderer.py:161-164 pads them
    (origin 0, direction (1, 1, 1)), and the padding is cut off again."""
    N = rays_o.shape[0]
    pad = (-N) % chunk
    if pad:
        rays_o = torch.cat([rays_o, rays_o.new_zeros(pad, 3)])
        rays_d = torch.cat([rays_d, rays_d.new_ones(pad, 3)])
    parts = [render_fn(rays_o[s:s + chunk], rays_d[s:s + chunk])
             for s in range(0, N + pad, chunk)]
    return {k: torch.cat([p[k] for p in parts])[:N] for k in parts[0]}
