"""DVGO model-zoo variants (counterpart of dreamfusion_tpu/models/zoo.py;
reference frameworks/nerf/modules/*_fine.py):

- DVGO_Plus   (dvp_fine.py): sigmoid-activated k0 features;
- NeRFWoNN    (nwnn_fine.py): Plenoxels-style SH colour, no colour MLP;
- FFL         (ffl_fine.py): LIIF-style per-corner MLP predictions of
  (rgb, alpha multiplier) blended by the trilinear weights;
- FastFFL     (fastffl_fine.py): one corner per sample, drawn by the
  inverse CDF of the trilinear weights;
- DVGO360     (dvgo360_coarse.py): unbounded scenes through the per
  coordinate contraction x -> center + sgn * r (1 + bg_dis - bg_dis / |x^|).

All subclass models/dvgo.DVGOField and share its renderer, trainer and
pipeline; the registry mirrors modules/__init__.py:12-43, and ``get_field``
imports models/osr.py (which registers the OSR fields) for names that start
with "osr", as the JAX package's does.

FFL and FastFFL run their decoder only where the sample's alpha exceeds
alpha_thres (the JAX package decodes every sample and then masks, which
gives the same values and gradients). FastFFL's draw is ``choice_u`` [N, S,
1] uniforms (the JAX package's uniform(k_noise)); without it FastFFL blends
all corners as FFL does (eval).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from dreamfusion_torch.models.dvgo import (DVGOField, fill_live,
                                           frequency_encoding, live_index)
from dreamfusion_torch.ops.encoders import sh_encode


class DVGO_Plus(DVGOField):
    """k0 passed through a sigmoid before the rgbnet (dvp_fine.py:12-23)."""

    def query_k0(self, pts):
        return torch.sigmoid(super().query_k0(pts))


class NeRFWoNN(DVGOField):
    """Plenoxels-style SH colours: k0 holds 3 * degree^2 SH coefficients;
    colour = sigmoid(sum_l sh_l(view) * k0_l) (nwnn_fine.py:10-33)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        n_sh = self.k0_dim // 3
        if self.k0_dim % 3 or math.isqrt(n_sh) ** 2 != n_sh:
            raise ValueError(f"k0_dim must be 3 * degree^2, got {self.k0_dim}")

    def query_rgb(self, pts, viewdirs):
        n_sh = self.k0_dim // 3
        k0 = self.query_k0(pts)                                  # [..., 3 n_sh]
        vd = viewdirs / torch.linalg.norm(viewdirs, dim=-1, keepdim=True)
        sh = sh_encode(vd, degree=math.isqrt(n_sh))              # [..., n_sh]
        coeffs = k0.reshape(*k0.shape[:-1], 3, n_sh)
        return torch.sigmoid((sh[..., None, :] * coeffs).sum(-1))


# corner offsets, ordered so that flipping the trilinear weight order pairs
# corner i with the weight of corner 7 - i (ffl_fine.py:65-74)
_CELL_BASE = ((0, 0, 1), (0, 0, 0), (0, 1, 1), (0, 1, 0),
              (1, 0, 1), (1, 0, 0), (1, 1, 1), (1, 1, 0))


class FFL(DVGOField):
    """LIIF field: the rgbnet predicts (rgb, alpha multiplier) at each of
    the 8 surrounding voxel corners from (corner k0, relative position PE,
    view PE); the predictions blend by the trilinear weights
    (ffl_fine.py:8-56)."""

    default_rgbnet = "basicmlp"
    rgbnet_out = 4

    def __init__(self, *args, alpha_thres: float = 1e-4, **kw):
        super().__init__(*args, **kw)
        self.alpha_thres = alpha_thres

    @property
    def voxel_size_each(self) -> torch.Tensor:
        ws = torch.tensor(self.world_size, dtype=torch.float32,
                          device=self.mins.device)
        return (self.maxs - self.mins) / (ws - 1.0)

    def _liif_features(self, rays_pts, viewdirs):
        """-> (pred [..., 8, 4], weights [..., 8]) at the 8 corners."""
        vse = self.voxel_size_each
        ws = torch.tensor(self.world_size, dtype=torch.float32,
                          device=vse.device)
        rel0 = rays_pts - self.mins
        cell = torch.clamp(torch.minimum(torch.floor(rel0 / vse), ws - 2.0),
                           min=0.0)
        base = torch.tensor(_CELL_BASE, dtype=torch.float32, device=vse.device)
        cells = cell[..., None, :] + base                          # [..., 8, 3]
        relatives = rel0[..., None, :] - cells * vse               # [..., 8, 3]
        w = torch.abs(torch.prod(relatives, -1)).flip(-1) / torch.prod(vse)

        idx = cells.long()
        X, Y, Z = self.world_size
        lin = (idx[..., 0] * Y + idx[..., 1]) * Z + idx[..., 2]    # [..., 8]
        k0s = self.k0.reshape(self.k0_dim, -1).t()[lin]            # [..., 8, C]

        feats = [k0s]
        if self.posbase_pe:
            feats.append(frequency_encoding(relatives, self.posbase_pe))
        if self.viewbase_pe:
            vd = viewdirs[..., None, :].expand(relatives.shape)
            feats.append(frequency_encoding(vd, self.viewbase_pe))
        return self.rgbnet(torch.cat(feats, -1)), w

    @staticmethod
    def _blend(pred, w):
        rgb = (torch.sigmoid(pred[..., :3]) * w[..., None]).sum(-2)
        alpha_mul = (torch.sigmoid(pred[..., 3]) * w).sum(-1)
        return rgb, alpha_mul

    def _live_alpha(self, rays_pts, mask_oob, noise):
        alpha_vox = torch.where(mask_oob, 0.0, self.query_alpha(rays_pts, noise))
        return alpha_vox, live_index(alpha_vox > self.alpha_thres)

    def _render_core(self, rays_pts, mask_oob, viewdirs, noise=None):
        alpha_vox, idx = self._live_alpha(rays_pts, mask_oob, noise)
        pred, w = self._liif_features(rays_pts[idx], viewdirs[idx[0]])
        rgb, alpha_mul = self._blend(pred, w)
        return (fill_live(alpha_vox.shape, 0.0, idx, alpha_vox[idx] * alpha_mul),
                fill_live(rays_pts.shape, 0.0, idx, rgb))


class FastFFL(FFL):
    """Stochastic single-corner LIIF: one corner per sample, drawn by the
    inverse CDF of the trilinear weights (fastffl_fine.py:9-40). choice_u:
    [N, S, 1] uniforms; without it, FFL's expected blend (eval). With it
    the density takes no noise, as in the JAX package."""

    def draw_spec(self, n_rays, n_samples):
        return {"jitter": ((n_rays, 1), "uniform"),
                "choice_u": ((n_rays, n_samples, 1), "uniform")}

    def _render_core(self, rays_pts, mask_oob, viewdirs, noise=None,
                     choice_u: Optional[torch.Tensor] = None):
        if choice_u is None:
            return super()._render_core(rays_pts, mask_oob, viewdirs, None)
        alpha_vox, idx = self._live_alpha(rays_pts, mask_oob, None)
        pred, w = self._liif_features(rays_pts[idx], viewdirs[idx[0]])
        cdf = torch.cumsum(w, -1) + 1e-3
        choice = torch.clamp((cdf < choice_u[idx]).sum(-1), 0, 7)     # [L]
        picked = pred.gather(-2, choice[:, None, None].expand(-1, 1, 4))[:, 0]
        alpha = alpha_vox[idx] * torch.sigmoid(picked[..., 3])
        return (fill_live(alpha_vox.shape, 0.0, idx, alpha),
                fill_live(rays_pts.shape, 0.0, idx,
                          torch.sigmoid(picked[..., :3])))


class DVGO360(DVGOField):
    """Unbounded scenes through contracted coordinates
    (dvgo360_coarse.py:35-63); the grid covers the contracted space scaled
    by (1 + bg_dis). sample_ray keeps the inner box (mins, maxs)."""

    def __init__(self, *args, bg_dis: float = 0.2, **kw):
        super().__init__(*args, **kw)
        self.bg_dis = bg_dis

    def _center_r(self):
        return (self.mins + self.maxs) / 2.0, (self.maxs - self.mins) / 2.0

    def world_to_contract(self, xyz):
        """Per coordinate (dvgo360_coarse.py:35-42: the inner mask is
        elementwise)."""
        center, r = self._center_r()
        inner = (xyz >= self.mins) & (xyz <= self.maxs)
        rel = (xyz - center) / r
        a = torch.clamp(torch.abs(rel), min=1e-9)
        contracted = center + r * (1.0 + self.bg_dis - self.bg_dis / a) \
            * torch.sign(rel)
        return torch.where(inner, xyz, contracted)

    def contract_to_world(self, xyz):
        center, r = self._center_r()
        inner = (xyz >= self.mins) & (xyz <= self.maxs)
        rel = (xyz - center) / r
        world = center + r * torch.sign(rel) * (
            self.bg_dis / torch.clamp(1.0 + self.bg_dis - torch.abs(rel),
                                      min=1e-9))
        return torch.where(inner, xyz, world)

    def normalize(self, pts):
        """Contracted coordinates -> [0, 1] over the expanded grid extent
        (dvgo360_coarse.py's grid sampler maps by r (1 + bg_dis))."""
        c = self.world_to_contract(pts)
        center, r = self._center_r()
        return (c - center) / (2.0 * r * (1.0 + self.bg_dis)) + 0.5


# the registry (modules/__init__.py:12-30); the OSR fields register on
# import of models/osr.py
field_registry = {
    "dvgo_coarse": DVGOField,
    "dvgo_fine": DVGOField,
    "dvp_fine": DVGO_Plus,
    "nwnn_fine": NeRFWoNN,
    "ffl_fine": FFL,
    "fastffl_fine": FastFFL,
    "dvgo360_coarse": DVGO360,
    "dvgo360_fine": DVGO360,
}


def get_field(name: str, **kwargs) -> DVGOField:
    if name.startswith("osr"):
        from dreamfusion_torch.models import osr  # noqa: F401  (registers)
    return field_registry[name](**kwargs)
