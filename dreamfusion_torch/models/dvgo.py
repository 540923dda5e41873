"""DVGO (Direct Voxel Grid Optimization) scene fields (counterpart of
dreamfusion_tpu/models/dvgo.py; reference frameworks/nerf/modules/
dvgo_coarse.py, dvgo_fine.py):

- dense voxel grids: density [1, X, Y, Z] and colour / feature k0
  [C, X, Y, Z], trilinearly sampled (ops/grid_sample.py);
- post-activated density: alpha = 1 - exp(-softplus(d + act_shift) *
  interval), act_shift = log(1 / (1 - alpha_init) - 1);
- coarse model (rgbnet_name None): k0 is the colour through a sigmoid;
  fine model: k0 features + positional and view encodings -> a registered
  rgbnet MLP (models/decoders.py);
- fixed-count ray sampling within the scene box (datasets/nerf/utils.py:
  5-28) and exclusive-cumprod compositing with the background and a
  far-depth fill (dvgo_coarse.py:309-352);
- the training losses (dvgo_coarse.py:216-296), total variation and the
  shuffled-TV metric loss, the MaskCache free-space test
  (modules/utils.py:14-33) and progressive grid scaling
  (dvgo_fine.py:35-42).

Random draws are optional tensors: the ray jitter of ``render`` and
``sample_ray`` ([N, 1] uniforms), the density noise ([N, S] normals) and
the three permutations of ``metric_loss``; without them the render draws
nothing (the JAX package's key=None) and ``metric_loss`` draws from its
generator.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dreamfusion_torch.models.decoders import get_MLP
from dreamfusion_torch.ops.grid_sample import (grid_sample_3d, max_pool_3d,
                                               resize_grid_trilinear)


def position_encoding(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """[x, sin(f x), cos(f x)] flattened (modules/utils.py:129-131)."""
    emb = (x[..., None] * freqs).reshape(*x.shape[:-1],
                                         x.shape[-1] * freqs.shape[0])
    return torch.cat([x, torch.sin(emb), torch.cos(emb)], -1)


def cumprod_exclusive(p: torch.Tensor) -> torch.Tensor:
    """[1, p0, p0 p1, ...] with a 1e-10 clamp (modules/utils.py:35-37); one
    more entry than the input, like the reference."""
    c = torch.cumprod(torch.clamp(p, min=1e-10), dim=-1)
    return torch.cat([torch.ones_like(p[..., :1]), c], -1)


def total_variation(v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean |diff| over the three spatial axes of [C, X, Y, Z]
    (modules/utils.py:46-56)."""
    tvs = []
    for axis in (1, 2, 3):
        d = torch.abs(torch.diff(v, dim=axis))
        if mask is None:
            tvs.append(d.mean())
            continue
        n = mask.shape[axis]
        m = mask.narrow(axis, 0, n - 1) & mask.narrow(axis, 1, n - 1)
        d = torch.where(m, d, torch.zeros_like(d))
        tvs.append(d.sum() / torch.clamp(m.sum() * v.shape[0], min=1))
    return sum(tvs) / 3.0


def metric_loss(v: torch.Tensor,
                perms: Optional[Sequence[torch.Tensor]] = None,
                mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Shuffled-TV contrast: TV(v) minus the TV of spatially permuted v
    (modules/utils.py:58-63). perms: the three permutations of axes 1, 2
    and 3 (drawn from `generator` when not given)."""
    if perms is None:
        perms = [torch.randperm(v.shape[a], generator=generator).to(v.device)
                 for a in (1, 2, 3)]
    sh = v[:, perms[0]][:, :, perms[1]][:, :, :, perms[2]]
    if mask is not None:
        diff = torch.where(mask, torch.abs(v - sh), torch.zeros_like(v))
        contrast = diff.sum() / torch.clamp(mask.sum() * v.shape[0], min=1)
    else:
        contrast = torch.abs(v - sh).mean()
    return total_variation(v, mask) - contrast


def sample_ray(rays_o: torch.Tensor, rays_d: torch.Tensor, *, near: float,
               far: float, xyz_min: torch.Tensor, xyz_max: torch.Tensor,
               voxel_size: float, stepsize: float, n_samples: int,
               jitter: Optional[torch.Tensor] = None):
    """Fixed-count box-clipped ray sampling (datasets/nerf/utils.py:5-28).
    Returns (rays_pts [N, S, 3], mask_outbbox [N, S]). jitter (optional,
    train time): [N, 1] uniforms added to the sample indices."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (xyz_max - rays_o) / vec
    rate_b = (xyz_min - rays_o) / vec
    t_min = torch.clamp(torch.minimum(rate_a, rate_b).amax(-1), near, far)
    t_max = torch.clamp(torch.maximum(rate_a, rate_b).amin(-1), near, far)
    mask_outbbox = t_max <= t_min
    rng = torch.arange(n_samples, dtype=torch.float32,
                       device=rays_o.device)[None, :]
    if jitter is not None:
        rng = rng + jitter
    step = stepsize * voxel_size * rng
    interpx = t_min[:, None] + step / torch.linalg.norm(rays_d, dim=-1,
                                                        keepdim=True)
    rays_pts = rays_o[:, None, :] + rays_d[:, None, :] * interpx[..., None]
    oob = ((rays_pts < xyz_min) | (rays_pts > xyz_max)).any(-1)
    return rays_pts, mask_outbbox[:, None] | oob


class DVGOField(nn.Module):
    """One DVGO scene field: coarse when rgbnet_name is None, else fine."""

    def __init__(self, world_size: Tuple[int, int, int], k0_dim: int = 3,
                 rgbnet_name: Optional[str] = None, rgbnet_width: int = 128,
                 rgbnet_depth: int = 3, posbase_pe: int = 5,
                 viewbase_pe: int = 4,
                 xyz_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0),
                 xyz_max: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                 alpha_init: float = 1e-6, stepsize: float = 0.5,
                 voxel_size_ratio: float = 1.0,
                 fast_color_thres: float = 1e-7, density_noise: float = 0.0):
        super().__init__()
        self.world_size = tuple(int(s) for s in world_size)
        self.k0_dim = k0_dim
        self.rgbnet_name = rgbnet_name
        self.rgbnet_width, self.rgbnet_depth = rgbnet_width, rgbnet_depth
        self.posbase_pe, self.viewbase_pe = posbase_pe, viewbase_pe
        self.xyz_min = tuple(float(v) for v in xyz_min)
        self.xyz_max = tuple(float(v) for v in xyz_max)
        self.alpha_init = alpha_init
        self.stepsize = stepsize
        self.voxel_size_ratio = voxel_size_ratio
        self.fast_color_thres = fast_color_thres
        self.density_noise = density_noise
        X, Y, Z = self.world_size
        self.density = nn.Parameter(torch.empty(1, X, Y, Z))
        self.k0 = nn.Parameter(torch.empty(k0_dim, X, Y, Z))
        self.register_buffer("mins", torch.tensor(self.xyz_min),
                             persistent=False)
        self.register_buffer("maxs", torch.tensor(self.xyz_max),
                             persistent=False)
        self.rgbnet = None
        if rgbnet_name is not None:
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
        if self.rgbnet is not None:
            self.rgbnet.reset_parameters(generator)

    @property
    def act_shift(self) -> float:
        return math.log(1.0 / (1.0 - self.alpha_init) - 1.0)

    @property
    def voxel_size(self) -> float:
        """The mean voxel edge, in float64 as numpy takes it (the JAX
        package's n_render_samples and ray steps read this value)."""
        ext = np.array(self.xyz_max) - np.array(self.xyz_min)
        return float((ext / np.array(self.world_size)).mean())

    # -- queries ---------------------------------------------------------------

    def normalize(self, pts: torch.Tensor) -> torch.Tensor:
        return (pts - self.mins) / (self.maxs - self.mins)

    def sample_density(self, pts: torch.Tensor) -> torch.Tensor:
        return grid_sample_3d(self.density, self.normalize(pts))[..., 0]

    def activate_density(self, density: torch.Tensor,
                         interval: Optional[float] = None) -> torch.Tensor:
        if interval is None:
            interval = self.stepsize * self.voxel_size_ratio
        return 1.0 - torch.exp(-F.softplus(density + self.act_shift) * interval)

    def query_alpha(self, pts: torch.Tensor,
                    noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """noise (optional): standard normals of the density's shape, scaled
        by density_noise (train time)."""
        d = self.sample_density(pts)
        if noise is not None and self.density_noise > 0:
            d = d + noise * self.density_noise
        return self.activate_density(d)

    def query_rgb(self, pts: torch.Tensor,
                  viewdirs: torch.Tensor) -> torch.Tensor:
        k0 = grid_sample_3d(self.k0, self.normalize(pts))
        if self.rgbnet is None:       # coarse: direct colour (dvgo_coarse.py:355)
            return torch.sigmoid(k0)
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

    # -- rendering (dvgo_coarse.py:309-366) ------------------------------------

    def _render_core(self, rays_pts, mask_oob, viewdirs, noise=None):
        """(alpha [N, S], rgb [N, S, 3]): the per-sample queries
        (dvgo_coarse.py:354-361). The colour is queried only where the
        sample's weight exceeds fast_color_thres and is 0.5 elsewhere; the
        JAX package queries every sample and then masks, which gives the
        same values and gradients. The zoo's variants override this hook."""
        alpha = torch.where(mask_oob, 0.0, self.query_alpha(rays_pts, noise))
        with torch.no_grad():
            weights = alpha * cumprod_exclusive(1.0 - alpha)[..., :-1]
            sel = weights > self.fast_color_thres
        rgb = torch.full(rays_pts.shape, 0.5, dtype=torch.float32,
                         device=rays_pts.device)
        idx = sel.nonzero(as_tuple=True)
        vd = viewdirs[idx[0]]
        rgb = rgb.index_put(idx, self.query_rgb(rays_pts[idx], vd))
        return alpha, rgb

    def render(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
               viewdirs: torch.Tensor, *, near: float, far: float, bg,
               n_samples: int, jitter: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """DVGO's volume render of N rays. jitter [N, 1] and noise [N, S]:
        the train-time draws (see module docstring)."""
        rays_pts, mask_oob = sample_ray(
            rays_o, rays_d, near=near, far=far, xyz_min=self.mins,
            xyz_max=self.maxs, voxel_size=self.voxel_size,
            stepsize=self.stepsize, n_samples=n_samples, jitter=jitter)
        alpha, rgb = self._render_core(rays_pts, mask_oob, viewdirs, noise)
        alphainv_cum = cumprod_exclusive(1.0 - alpha)           # [N, S+1]
        weights = alpha * alphainv_cum[..., :-1]
        bg = torch.as_tensor(bg, dtype=torch.float32, device=rays_o.device)
        rgb_marched = torch.clamp(
            (weights[..., None] * rgb).sum(-2)
            + alphainv_cum[..., -1:] * bg, 0.0, 1.0)
        dists = torch.linalg.norm(rays_o[:, None, :] - rays_pts, dim=-1)
        depth = (weights * dists).sum(-1) + alphainv_cum[..., -1] * far
        return {"alphainv_cum": alphainv_cum, "weights": weights,
                "rgb_marched": rgb_marched, "raw_alpha": alpha,
                "raw_rgb": rgb, "depths": depth, "disp": 1.0 / depth,
                "dists": dists}

    def n_render_samples(self, far: float) -> int:
        return int(far / self.voxel_size / self.stepsize) + 1


# -- losses (dvgo_coarse.py:216-296) ---------------------------------------------

def dvgo_losses(render: Dict[str, torch.Tensor], target: torch.Tensor, *,
                weight_main: float = 1.0, weight_entropy_last: float = 0.0,
                weight_rgbper: float = 0.0, entropy_weight: float = 0.0,
                weight_depth: float = 0.0,
                target_depth: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logs = {}
    if weight_depth > 0:  # depth supervision (dvgo_coarse.py:258-267)
        assert target_depth is not None
        d_loss = ((render["depths"] - target_depth) ** 2).mean()
        before = render["dists"] < target_depth[..., None] * 0.99
        dist_loss = torch.where(before, render["weights"],
                                torch.zeros_like(render["weights"])).sum() \
            / torch.clamp(before.sum(), min=1)
        logs["loss_depth"] = weight_depth * d_loss
        logs["loss_dist"] = weight_depth * dist_loss
    loss = weight_main * ((render["rgb_marched"] - target) ** 2).mean()
    logs["loss_main"] = loss
    if weight_entropy_last > 0:
        pout = torch.clamp(render["alphainv_cum"][..., -1], 1e-6, 1 - 1e-6)
        ent = -(pout * torch.log(pout)
                + (1 - pout) * torch.log(1 - pout)).mean()
        logs["loss_entropy_last"] = weight_entropy_last * ent
        loss = loss + logs["loss_entropy_last"]
    if weight_rgbper > 0:
        rgbper = ((render["raw_rgb"] - target[..., None, :]) ** 2).sum(-1)
        per = (rgbper * render["weights"].detach()).sum(-1).mean()
        logs["loss_rgbper"] = weight_rgbper * per
        loss = loss + logs["loss_rgbper"]
    if entropy_weight > 0:  # unimodal ray-weight entropy (dvgo_coarse.py:288-295)
        w = render["weights"]
        nw = w / (w.sum(-1, keepdim=True) + 1e-10)
        ent = -(nw * torch.log2(nw + 1e-10)).sum(-1)
        ent = ent * (w.sum(-1) > 1e-2).detach()
        logs["loss_ray_entropy"] = entropy_weight * ent.mean()
        loss = loss + logs["loss_ray_entropy"]
    if weight_depth > 0:
        loss = loss + logs["loss_depth"] + logs["loss_dist"]
    return loss, logs


# -- MaskCache (modules/utils.py:14-33) ----------------------------------------------

class MaskCacheData:
    """Known-free-space test from a coarse model's (max-pooled) density."""

    def __init__(self, xyz_min, xyz_max, density, act_shift, voxel_size_ratio,
                 mask_cache_thres, ks: int = 3):
        density = torch.as_tensor(density).detach()
        self.xyz_min = torch.as_tensor(xyz_min, dtype=torch.float32,
                                       device=density.device)
        self.xyz_max = torch.as_tensor(xyz_max, dtype=torch.float32,
                                       device=density.device)
        self.density = max_pool_3d(density, ks)
        self.act_shift = act_shift
        self.voxel_size_ratio = voxel_size_ratio
        self.thres = mask_cache_thres

    def __call__(self, xyz: torch.Tensor) -> torch.Tensor:
        x01 = (xyz - self.xyz_min) / (self.xyz_max - self.xyz_min)
        d = grid_sample_3d(self.density, x01)[..., 0]
        alpha = 1.0 - torch.exp(-F.softplus(d + self.act_shift)
                                * self.voxel_size_ratio)
        return alpha >= self.thres


@torch.no_grad()
def scale_volume_grid(field: DVGOField, new_world_size) -> DVGOField:
    """Progressive scaling: trilinear re-interpolation of density and k0 to
    the new resolution (dvgo_fine.py:35-42), in place: the field gets new
    grid parameters and its world_size (the JAX package returns a new
    params dict and a copied module)."""
    new_world_size = tuple(int(s) for s in new_world_size)
    field.density = nn.Parameter(resize_grid_trilinear(field.density,
                                                       new_world_size))
    field.k0 = nn.Parameter(resize_grid_trilinear(field.k0, new_world_size))
    field.world_size = new_world_size
    return field
