"""OSR (outdoor scene relighting) DVGO variants (counterpart of
dreamfusion_tpu/models/osr.py; reference frameworks/nerf/modules/
osr_fine.py): a learned SH environment ``env`` [9, 3], per-sample shadow,
density-gradient normals and SH irradiance shading.

- OSR_Fine     irradiance applied to the marched aggregates (osr_fine.py:
               57-117);
- OSR_Fine_V2  irradiance applied per sample before compositing (:120-186);
- OSR_Fine_V3  shadow only: a view-dependent rgb times a floored shadow
               multiplier (:189-326); V4, V5 and V6 with sigmoid, (the
               same) and zero-initialised k0 (:329-360);
- OSR_Fine_RGI chromaticity (r, g) and illuminance I (:363-455);
- AnnealingPosEmbedder, coarse-to-fine frequency annealing (:469-524);
- illuminate_vec, SH irradiance from a normal (:533-554);
- the decoders ShadowMLP and SeparateShadowMLP, registered in
  models/decoders.py's registry on import.

The normal is d(sum alpha)/d(position) by torch.autograd.grad through
grid_sample_3d; in training the graph is kept (create_graph), so the
density takes a gradient through the normal, as under the JAX package's
nn.vjp. Under no_grad (evaluation, ImageRenderer) the normal is taken in a
local enable_grad and carries no graph.

The fields query their colour, shadow and normal only where the result
survives the mask (weights > fast_color_thres; OSR_Fine_V2's marched
normal sums every sample of nonzero weight), where the JAX package queries
every sample and then masks: the same values and gradients.

Draws: ``jitter`` [N, 1] for every field; OSR_Fine and OSR_Fine_V2 with
use_shadow_jitter also ``shadow_jitter`` [N, S, 9] standard normals (the
JAX package's 0.01 * normal(k_jit)).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dreamfusion_torch.models.decoders import _Decoder, _width, register_model
from dreamfusion_torch.models.dvgo import (DVGOField, cumprod_exclusive,
                                           fill_live, live_index, sample_ray)
from dreamfusion_torch.models.zoo import field_registry


def illuminate_vec(n: torch.Tensor, env: torch.Tensor) -> torch.Tensor:
    """SH irradiance for normals n [..., 3] under env [9, 3]
    (osr_fine.py:533-554)."""
    c1, c2, c3, c4, c5 = 0.282095, 0.488603, 1.092548, 0.315392, 0.546274
    x, y, z = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    e = env
    return (e[0] * c1 + e[1] * c2 * y + e[2] * c2 * z + e[3] * c2 * x
            + e[4] * c3 * x * y + e[5] * c3 * y * z
            + e[6] * c4 * (3 * z * z - 1) + e[7] * c3 * x * z
            + e[8] * c5 * (x * x - y * y))


def _safe_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=eps))


def _srgb_pow(x: torch.Tensor) -> torch.Tensor:
    """relu(x) ** (1/2.2) with a finite gradient at 0 (the reference's
    irradiance ** (1/2.2), osr_fine.py:82-83, is infinite there)."""
    safe = torch.clamp(x, min=1e-8)
    return torch.where(x > 0, safe ** (1.0 / 2.2), 0.0)


class AnnealingPosEmbedder(nn.Module):
    """Coarse-to-fine positional encoding: frequency band k is weighted by
    (1 - cos(pi * clip(alpha - k, 0, 1))) / 2 with alpha ramping over
    N_anneal steps (osr_fine.py:469-524, the nerfies annealing)."""

    def __init__(self, input_dim: int = 3, n_freqs: int = 10,
                 max_freq_log2: Optional[int] = None,
                 include_input: bool = True, N_anneal: int = 100000,
                 N_anneal_min_freq: int = 0, use_annealing: bool = True):
        super().__init__()
        self.input_dim, self.n_freqs = input_dim, n_freqs
        self.max_freq_log2 = max_freq_log2
        self.include_input = include_input
        self.N_anneal, self.N_anneal_min_freq = N_anneal, N_anneal_min_freq
        self.use_annealing = use_annealing

    def forward(self, x: torch.Tensor, step) -> torch.Tensor:
        dev = x.device
        maxf = self.max_freq_log2 if self.max_freq_log2 is not None \
            else self.n_freqs - 1
        freqs = 2.0 ** torch.linspace(0.0, maxf, self.n_freqs, device=dev)
        if self.use_annealing:
            alpha = (self.n_freqs - self.N_anneal_min_freq) * torch.as_tensor(
                step, dtype=torch.float32, device=dev) / self.N_anneal
            ks = torch.arange(self.n_freqs, dtype=torch.float32, device=dev)
            w = (1.0 - torch.cos(math.pi * torch.clamp(alpha - torch.clamp(
                ks - self.N_anneal_min_freq, min=0.0), 0.0, 1.0))) / 2.0
            w = torch.where(ks < self.N_anneal_min_freq, 1.0, w)
        else:
            w = torch.ones(self.n_freqs, device=dev)
        emb = x[..., None] * freqs                          # [..., D, F]
        parts = [torch.sin(emb) * w, torch.cos(emb) * w]
        out = torch.cat([p.reshape(*x.shape[:-1], -1) for p in parts], -1)
        if self.include_input:
            out = torch.cat([x, out], -1)
        return out


@register_model
class ShadowMLP(_Decoder):
    """rgb from k0 and a shadow head over (k0, the 9 grey SH coefficients)
    (decoders/mlps.py:79-103)."""

    def __init__(self, in_dim: int = 0, out_dim: int = 4, width: int = 128,
                 depth: int = 3, k0_dim: int = 6, shadow_dim: int = 0):
        super().__init__()
        self.depth, self.k0_dim = depth, k0_dim
        base_w = _width(in_dim, slice(None, k0_dim))
        self.rgb_0 = nn.Linear(base_w, width)
        for i in range(depth - 2):
            self.add_module(f"rgb_{i + 1}", nn.Linear(width, width))
        self.rgb_out = nn.Linear(width, 3)
        self.shadow_0 = nn.Linear(base_w + _width(in_dim, slice(-9, None)),
                                  width // 2)
        self.shadow_out = nn.Linear(width // 2, 1)
        self.reset_parameters()

    def forward(self, x):
        base = x[..., :self.k0_dim]
        h = F.relu(self.rgb_0(base))
        for i in range(self.depth - 2):
            h = F.relu(getattr(self, f"rgb_{i + 1}")(h))
        s = F.relu(self.shadow_0(torch.cat([base, x[..., -9:]], -1)))
        return torch.cat([self.rgb_out(h), self.shadow_out(s)], -1)


@register_model
class SeparateShadowMLP(_Decoder):
    """Feature split (decoders/mlps.py:233-253): rgb from the first k0_dim -
    shadow_dim features; shadow from the last shadow_dim + 9."""

    def __init__(self, in_dim: int = 0, out_dim: int = 4, width: int = 128,
                 depth: int = 3, k0_dim: int = 12, shadow_dim: int = 2):
        super().__init__()
        self.depth = depth
        self.rgb_dim, self.shadow_dim = k0_dim - shadow_dim, shadow_dim
        self.rgb_0 = nn.Linear(_width(in_dim, slice(None, self.rgb_dim)), width)
        for i in range(depth - 2):
            self.add_module(f"rgb_{i + 1}", nn.Linear(width, width))
        self.rgb_out = nn.Linear(width, 3)
        self.shadow_0 = nn.Linear(
            _width(in_dim, slice(-9 - shadow_dim, None)), width // 2)
        self.shadow_out = nn.Linear(width // 2, 1)
        self.reset_parameters()

    def forward(self, x):
        h = F.relu(self.rgb_0(x[..., :self.rgb_dim]))
        for i in range(self.depth - 2):
            h = F.relu(getattr(self, f"rgb_{i + 1}")(h))
        s = F.relu(self.shadow_0(x[..., -9 - self.shadow_dim:]))
        return torch.cat([self.rgb_out(h), self.shadow_out(s)], -1)


def _composite(field, rays_o, rays_d, near, far, n_samples, jitter):
    """The shared front of the OSR renders: samples, alpha, transmittance
    and weights."""
    rays_pts, mask_oob = sample_ray(
        rays_o, rays_d, near=near, far=far, xyz_min=field.mins,
        xyz_max=field.maxs, voxel_size=field.voxel_size,
        stepsize=field.stepsize, n_samples=n_samples, jitter=jitter)
    alpha = torch.where(mask_oob, 0.0, field.query_alpha(rays_pts))
    alphainv_cum = cumprod_exclusive(1.0 - alpha)
    return rays_pts, alpha, alphainv_cum, alpha * alphainv_cum[..., :-1]


def _depth(rays_o, rays_pts, weights, alphainv_cum, far):
    dists = torch.linalg.norm(rays_o[:, None, :] - rays_pts, dim=-1)
    depth = (weights * dists).sum(-1) + alphainv_cum[..., -1] * far
    return dists, depth


class OSR_Fine(DVGOField):
    """SH-environment relighting; irradiance applied to the marched
    aggregates. The rgbnet (a ShadowMLP-like decoder) is fed k0 and the 9
    grey environment coefficients (osr_fine.py:19-20)."""

    def __init__(self, *args, use_shadow: bool = True,
                 use_shadow_jitter: bool = True, shadow_bar: float = 0.0,
                 **kw):
        super().__init__(*args, **kw)
        self.use_shadow, self.use_shadow_jitter = use_shadow, use_shadow_jitter
        self.shadow_bar = shadow_bar
        self.env = nn.Parameter(torch.empty(9, 3))

    def rgbnet_in_dim(self) -> int:
        return self.k0_dim + 9

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        with torch.no_grad():
            self.env.normal_(generator=generator)

    def draw_spec(self, n_rays, n_samples):
        spec = {"jitter": ((n_rays, 1), "uniform")}
        if self.use_shadow_jitter:
            spec["shadow_jitter"] = ((n_rays, n_samples, 9), "normal")
        return spec

    def alpha_gradient(self, pts: torch.Tensor) -> torch.Tensor:
        """d(sum alpha)/d(pts) (osr_fine.py:41-50): differentiable with
        respect to the density when grad is enabled, a plain value under
        no_grad."""
        keep = torch.is_grad_enabled()
        with torch.enable_grad():
            p = pts.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(self.query_alpha(p).sum(), p,
                                       create_graph=keep)
        return g

    def query_rgb_shadow(self, pts, shadow_jitter=None):
        """(rgb, shadow) at pts [L, 3]; shadow_jitter [L, 9] normals."""
        env_gray = (self.env[:, 0] * 0.2126 + self.env[:, 1] * 0.7152
                    + self.env[:, 2] * 0.0722)
        fg_sph = env_gray.expand(*pts.shape[:-1], 9)
        if self.use_shadow_jitter and shadow_jitter is not None:
            fg_sph = fg_sph + shadow_jitter * 0.01
        out = self.rgbnet(torch.cat([self.query_k0(pts), fg_sph], -1))
        return torch.sigmoid(out[..., :3]), torch.sigmoid(out[..., 3:4])

    def _live_queries(self, rays_pts, weights, shadow_jitter):
        idx = live_index(weights > self.fast_color_thres)
        sj = shadow_jitter[idx] if shadow_jitter is not None else None
        rgb, shadow = self.query_rgb_shadow(rays_pts[idx], sj)
        return idx, rgb, shadow

    def render(self, rays_o, rays_d, viewdirs, *, near, far, bg, n_samples,
               jitter=None, shadow_jitter=None):
        rays_pts, alpha, alphainv_cum, weights = _composite(
            self, rays_o, rays_d, near, far, n_samples, jitter)
        idx, rgb_l, shadow_l = self._live_queries(rays_pts, weights,
                                                  shadow_jitter)
        normal_l = self.alpha_gradient(rays_pts[idx])
        shape = rays_pts.shape
        rgb = fill_live(shape, 0.5, idx, rgb_l)
        shadow = fill_live(shape[:-1] + (1,), 1.0, idx, shadow_l)
        inv_sqrt3 = float(1.0 / torch.sqrt(torch.tensor(3.0)))
        normal = _safe_normalize(fill_live(shape, inv_sqrt3, idx, normal_l))

        w = weights[..., None]
        rgb_albedo = (w * rgb).sum(-2)
        normal_m = _safe_normalize((w * normal).sum(-2))
        shadow_m = (w * shadow).sum(-2)
        irr = _srgb_pow(illuminate_vec(normal_m, self.env))
        bg = torch.as_tensor(bg, dtype=torch.float32, device=rays_o.device)
        if self.use_shadow:
            rgb_m = irr * rgb_albedo * shadow_m + alphainv_cum[..., -1:] * bg
        else:
            rgb_m = rgb_albedo + alphainv_cum[..., -1:] * bg
        dists, depth = _depth(rays_o, rays_pts, weights, alphainv_cum, far)
        return {"alphainv_cum": alphainv_cum, "weights": weights,
                "rgb_marched": rgb_m, "irradiance": irr,
                "shadow_marched": shadow_m, "normal_marched": normal_m,
                "raw_rgb": rgb, "raw_alpha": alpha, "depths": depth,
                "disp": 1.0 / depth, "dists": dists}


class OSR_Fine_V2(OSR_Fine):
    """Per-sample irradiance (osr_fine.py:120-186). Its marched normal sums
    the normal of every sample of nonzero weight."""

    def render(self, rays_o, rays_d, viewdirs, *, near, far, bg, n_samples,
               jitter=None, shadow_jitter=None):
        rays_pts, alpha, alphainv_cum, weights = _composite(
            self, rays_o, rays_d, near, far, n_samples, jitter)
        idx, rgb_l, shadow_l = self._live_queries(rays_pts, weights,
                                                  shadow_jitter)
        nz = live_index(weights > 0)
        shape = rays_pts.shape
        normal = fill_live(shape, 0.0, nz,
                           _safe_normalize(self.alpha_gradient(rays_pts[nz])))
        if self.use_shadow:
            irr = _srgb_pow(illuminate_vec(normal[idx], self.env))
            rgb_l = irr * rgb_l * shadow_l
        rgb = fill_live(shape, 0.5, idx, rgb_l)
        w = weights[..., None]
        bg = torch.as_tensor(bg, dtype=torch.float32, device=rays_o.device)
        rgb_m = (w * rgb).sum(-2) + alphainv_cum[..., -1:] * bg
        dists, depth = _depth(rays_o, rays_pts, weights, alphainv_cum, far)
        normal_m = _safe_normalize((w * normal).sum(-2))
        shadow_m = (w * fill_live(shape[:-1] + (1,), 1.0, idx, shadow_l)).sum(-2)
        return {"alphainv_cum": alphainv_cum, "weights": weights,
                "rgb_marched": rgb_m, "shadow_marched": shadow_m,
                "normal_marched": normal_m, "raw_rgb": rgb,
                "raw_alpha": alpha, "depths": depth, "disp": 1.0 / depth,
                "dists": dists}


class OSR_Fine_V3(DVGOField):
    """Shadow only: a view-dependent rgb times a floored shadow multiplier
    (osr_fine.py:189-326)."""

    default_rgbnet = "basicmlp"
    rgbnet_out = 4

    def __init__(self, *args, use_shadow: bool = True,
                 shadow_bar: float = 0.2, **kw):
        super().__init__(*args, **kw)
        self.use_shadow, self.shadow_bar = use_shadow, shadow_bar

    def _rgbnet_out(self, pts, viewdirs):
        return self.rgbnet(self.rgbnet_input(self.query_k0(pts), pts,
                                             viewdirs))

    def query_rgb_shadow(self, pts, viewdirs):
        out = self._rgbnet_out(pts, viewdirs)
        rgb, shadow = torch.sigmoid(out[..., :3]), torch.sigmoid(out[..., 3:4])
        if self.use_shadow:
            shadow = self.shadow_bar + (1.0 - self.shadow_bar) * shadow
        else:
            shadow = torch.ones_like(shadow)
        return rgb, shadow

    def render(self, rays_o, rays_d, viewdirs, *, near, far, bg, n_samples,
               jitter=None):
        rays_pts, alpha, alphainv_cum, weights = _composite(
            self, rays_o, rays_d, near, far, n_samples, jitter)
        idx = live_index(weights > self.fast_color_thres)
        rgb_l, shadow_l = self.query_rgb_shadow(rays_pts[idx],
                                                viewdirs[idx[0]])
        shape = rays_pts.shape
        rgb = fill_live(shape, 0.5, idx, rgb_l)
        shadow = fill_live(shape[:-1] + (1,), 1.0, idx, shadow_l)
        bg = torch.clamp(torch.as_tensor(bg, dtype=torch.float32,
                                         device=rays_o.device), 0, 1)
        rgb_m = (weights[..., None] * rgb * shadow).sum(-2) \
            + alphainv_cum[..., -1:] * bg
        dists, depth = _depth(rays_o, rays_pts, weights, alphainv_cum, far)
        return {"alphainv_cum": alphainv_cum, "weights": weights,
                "rgb_marched": rgb_m, "raw_alpha": alpha, "raw_rgb": rgb,
                "raw_shadow": shadow, "depths": depth, "disp": 1.0 / depth,
                "dists": dists}


class OSR_Fine_V4(OSR_Fine_V3):
    """sigmoid k0 features (osr_fine.py:329-337)."""

    def query_k0(self, pts):
        return torch.sigmoid(super().query_k0(pts))


class OSR_Fine_V5(OSR_Fine_V4):
    """V4 with the metric loss restricted to the colour features
    (osr_fine.py:340-348); the field itself is V4's."""


class OSR_Fine_V6(OSR_Fine_V4):
    """Zero-initialised k0 (osr_fine.py:352-359)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        with torch.no_grad():
            self.k0.zero_()


class OSR_Fine_RGI(OSR_Fine_V3):
    """Chromaticity decomposition: R = r I 3, G = g I 3, B = (1 - r - g) I 3
    (osr_fine.py:363-455). It returns no raw_rgb, so it trains with
    weight_rgbper 0, as in the JAX package."""

    rgbnet_out = 3

    def __init__(self, *args, base_illuminance: float = 0.5, **kw):
        super().__init__(*args, **kw)
        self.base_illuminance = base_illuminance

    def query_k0(self, pts):
        return torch.sigmoid(super().query_k0(pts))

    def render(self, rays_o, rays_d, viewdirs, *, near, far, bg, n_samples,
               jitter=None):
        rays_pts, alpha, alphainv_cum, weights = _composite(
            self, rays_o, rays_d, near, far, n_samples, jitter)
        idx = live_index(weights > self.fast_color_thres)
        out = self._rgbnet_out(rays_pts[idx], viewdirs[idx[0]])
        illum_l = torch.clamp(out[..., 2:3], 0.0, 1.0) * (1.0 - self.shadow_bar) \
            + self.shadow_bar
        shape = rays_pts.shape
        rg = fill_live(shape[:-1] + (2,), 0.0, idx, out[..., :2])
        illum = fill_live(shape[:-1] + (1,), 0.0, idx, illum_l)

        illum = torch.clamp(illum + 0.5, min=0.0)
        rg = rg + torch.clamp(rg + 1.0 / 3.0, min=0.0)
        rgb = torch.cat([
            rg[..., 0:1] * illum * 3.0,
            rg[..., 1:2] * illum * 3.0,
            torch.clamp(1.0 - rg[..., 0:1] - rg[..., 1:2], min=0.0)
            * illum * 3.0,
        ], -1)
        bg = torch.clamp(torch.as_tensor(bg, dtype=torch.float32,
                                         device=rays_o.device), 0, 1)
        rgb_m = (weights[..., None] * rgb).sum(-2) + alphainv_cum[..., -1:] * bg
        dists, depth = _depth(rays_o, rays_pts, weights, alphainv_cum, far)
        return {"alphainv_cum": alphainv_cum, "weights": weights,
                "rgb_marched": rgb_m, "raw_alpha": alpha, "raw_rg": rg,
                "raw_shadow": illum, "depths": depth, "disp": 1.0 / depth,
                "dists": dists}


field_registry.update({
    "osr_fine": OSR_Fine,
    "osr_v2_fine": OSR_Fine_V2,
    "osr_v3_fine": OSR_Fine_V3,
    "osr_v4_fine": OSR_Fine_V4,
    "osr_v5_fine": OSR_Fine_V5,
    "osr_v6_fine": OSR_Fine_V6,
    "osr_rgi_fine": OSR_Fine_RGI,
})
