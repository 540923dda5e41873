"""DVGO (Direct Voxel Grid Optimization) fine scene field, in plain
PyTorch for the benchmark's reference (sunset1995/DirectVoxGO,
dvgo_coarse.py, dvgo_fine.py):

- dense voxel grids: density [1, X, Y, Z] and feature k0 [C, X, Y, Z],
  trilinearly sampled (ops/grid_sample.py);
- post-activated density: alpha = 1 - exp(-softplus(d + act_shift) *
  interval), act_shift = log(1 / (1 - alpha_init) - 1);
- k0 features + positional and view encodings -> the ResMLP rgbnet
  (models/decoders.py);
- fixed-count ray sampling within the scene box (datasets/nerf/utils.py:
  5-28) and exclusive-cumprod compositing with the background and a
  far-depth fill (dvgo_coarse.py:309-352);
- the training losses (dvgo_coarse.py:216-296).

The ray jitter of ``render`` and ``sample_ray`` ([N, 1] uniforms) is
given by the caller."""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dfref.models.decoders import get_MLP
from dfref.ops.grid_sample import grid_sample_3d


def position_encoding(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """[x, sin(f x), cos(f x)] flattened (modules/utils.py:129-131)."""
    emb = (x[..., None] * freqs).reshape(*x.shape[:-1],
                                         x.shape[-1] * freqs.shape[0])
    return torch.cat([x, torch.sin(emb), torch.cos(emb)], -1)


def frequency_encoding(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """position_encoding at the frequencies 2^0 .. 2^(n_freqs - 1)."""
    freqs = torch.exp2(torch.arange(n_freqs, device=x.device,
                                    dtype=torch.float32))
    return position_encoding(x, freqs)


def cumprod_exclusive(p: torch.Tensor) -> torch.Tensor:
    """[1, p0, p0 p1, ...] with a 1e-10 clamp (modules/utils.py:35-37); one
    more entry than the input, like the reference."""
    c = torch.cumprod(torch.clamp(p, min=1e-10), dim=-1)
    return torch.cat([torch.ones_like(p[..., :1]), c], -1)


def live_index(mask: torch.Tensor):
    """The indices of the True entries of a mask that no gradient follows
    (a tuple of index tensors, as index_put takes it)."""
    return mask.detach().nonzero(as_tuple=True)


def fill_live(shape, value: float, idx, vals: torch.Tensor) -> torch.Tensor:
    """A tensor of `shape` holding `value`, and `vals` at the live indices
    `idx` (the JAX package's where(live, queried, value))."""
    full = torch.full(shape, value, dtype=vals.dtype, device=vals.device)
    return full.index_put(idx, vals)


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
                 fast_color_thres: float = 1e-7):
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
        X, Y, Z = self.world_size
        self.density = nn.Parameter(torch.empty(1, X, Y, Z))
        self.k0 = nn.Parameter(torch.empty(k0_dim, X, Y, Z))
        self.register_buffer("mins", torch.tensor(self.xyz_min),
                             persistent=False)
        self.register_buffer("maxs", torch.tensor(self.xyz_max),
                             persistent=False)
        self.rgbnet = None
        if rgbnet_name is not None:
            self.rgbnet = get_MLP(rgbnet_name, in_dim=self.rgbnet_in_dim(),
                                  out_dim=3, width=rgbnet_width,
                                  depth=rgbnet_depth)

    def rgbnet_in_dim(self) -> int:
        """The width of what the field feeds its rgbnet: k0 and the
        position and view encodings (the JAX package's dim0)."""
        dim0 = self.k0_dim
        if self.posbase_pe:
            dim0 += 3 + 3 * self.posbase_pe * 2
        if self.viewbase_pe:
            dim0 += 3 + 3 * self.viewbase_pe * 2
        return dim0

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

    def query_alpha(self, pts: torch.Tensor) -> torch.Tensor:
        return self.activate_density(self.sample_density(pts))

    def query_k0(self, pts: torch.Tensor) -> torch.Tensor:
        """The k0 features at pts."""
        return grid_sample_3d(self.k0, self.normalize(pts))

    def rgbnet_input(self, k0: torch.Tensor, pts: torch.Tensor,
                     viewdirs: torch.Tensor) -> torch.Tensor:
        """[k0, PE(normalised position), PE(view direction)]: what a fine
        field feeds its rgbnet (dvgo_fine.py:45-54)."""
        feats = [k0]
        if self.posbase_pe:
            feats.append(frequency_encoding(self.normalize(pts),
                                            self.posbase_pe))
        if self.viewbase_pe:
            feats.append(frequency_encoding(viewdirs, self.viewbase_pe))
        return torch.cat(feats, -1)

    def query_rgb(self, pts: torch.Tensor,
                  viewdirs: torch.Tensor) -> torch.Tensor:
        k0 = self.query_k0(pts)
        if self.rgbnet is None:       # coarse: direct colour (dvgo_coarse.py:355)
            return torch.sigmoid(k0)
        return torch.sigmoid(self.rgbnet(self.rgbnet_input(k0, pts, viewdirs)))

    # -- rendering (dvgo_coarse.py:309-366) ------------------------------------

    def _render_core(self, rays_pts, mask_oob, viewdirs):
        """(alpha [N, S], rgb [N, S, 3]): the per-sample queries
        (dvgo_coarse.py:354-361). The colour is queried only where the
        sample's weight exceeds fast_color_thres and is 0.5 elsewhere."""
        alpha = torch.where(mask_oob, 0.0, self.query_alpha(rays_pts))
        with torch.no_grad():
            weights = alpha * cumprod_exclusive(1.0 - alpha)[..., :-1]
        idx = live_index(weights > self.fast_color_thres)
        rgb = self.query_rgb(rays_pts[idx], viewdirs[idx[0]])
        return alpha, fill_live(rays_pts.shape, 0.5, idx, rgb)

    def render(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
               viewdirs: torch.Tensor, *, near: float, far: float, bg,
               n_samples: int, jitter: Optional[torch.Tensor] = None
               ) -> Dict[str, torch.Tensor]:
        """DVGO's volume render of N rays; jitter [N, 1]: the train-time
        ray jitter."""
        rays_pts, mask_oob = sample_ray(
            rays_o, rays_d, near=near, far=far, xyz_min=self.mins,
            xyz_max=self.maxs, voxel_size=self.voxel_size,
            stepsize=self.stepsize, n_samples=n_samples, jitter=jitter)
        alpha, rgb = self._render_core(rays_pts, mask_oob, viewdirs)
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
                weight_rgbper: float = 0.0, entropy_weight: float = 0.0
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    logs = {}
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
    return loss, logs

