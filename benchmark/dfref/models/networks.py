"""stable-dreamfusion's grid field (nerf/network_grid.py), in plain
PyTorch for the benchmark's reference.

``_BaseNeRF`` holds what the fields share (density, background, the
normalise-and-NaN rule of the normal); ``NeRFGridNetwork`` is the grid
backbone, ``models/kailu.DVGOEditNetwork`` the editing field.

Grid backbone: tiled grid encoder (L=16, C=2, 2^16 table per level,
desired resolution 2048*bound) + 3x64 ReLU MLP -> (sigma, albedo),
gaussian density blob, trunc_exp, frequency-encoded 2x64 background MLP,
finite-difference normals, in float32.

Shading codes: 0 albedo, 1 lambertian, 2 textureless, 3 normal.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dfref.cameras import safe_normalize
from dfref.ops.activation import trunc_exp
from dfref.ops.encoders import freq_encode, freq_output_dim
from dfref.ops.grid_encoder import GridEncoderSpec

SHADING_ALBEDO = 0
SHADING_LAMBERTIAN = 1
SHADING_TEXTURELESS = 2
SHADING_NORMAL = 3


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's default kernel init: truncated normal (+-2 sigma) with
    variance 1/fan_in (the std is corrected for the truncation). Drawn by
    the inverse CDF of one uniform per entry, written out here so that a
    seed gives the same weights whatever torch's own trunc_normal_ does
    (its algorithm differs between releases)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))
    with torch.no_grad():
        w.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
        return w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std,
                                                              2.0 * std)


class MLP(nn.Module):
    """Plain ReLU MLP (reference network_grid.py:13-32). Layers are named
    dense_0..dense_{n-1} like the flax module."""

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int,
                 num_layers: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.num_layers = num_layers
        for l in range(num_layers):
            d_in = dim_in if l == 0 else dim_hidden
            d_out = dim_out if l == num_layers - 1 else dim_hidden
            self.add_module(f"dense_{l}", nn.Linear(d_in, d_out))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for l in range(self.num_layers):
            lin = getattr(self, f"dense_{l}")
            lecun_normal_(lin.weight, lin.in_features, generator)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for l in range(self.num_layers):
            lin = getattr(self, f"dense_{l}")
            x = F.linear(x, lin.weight.to(self.dtype), lin.bias.to(self.dtype))
            if l != self.num_layers - 1:
                x = F.relu(x)
        return x.float()


def gaussian_blob(x: torch.Tensor) -> torch.Tensor:
    """5 exp(-|x|^2 / (2 * 0.2^2)) (reference network_grid.py:68-74)."""
    d = (x * x).sum(-1)
    return 5.0 * torch.exp(-d / (2.0 * 0.2 ** 2))


def _shade(albedo, normal, light_d, ratio: float, shading_code: int):
    """Albedo / lambertian / textureless / normal shading
    (reference network_grid.py:133-144)."""
    code = min(max(int(shading_code), 0), 3)
    if code == SHADING_ALBEDO:
        return albedo
    if code == SHADING_NORMAL:
        return (normal + 1.0) / 2.0
    lam = ratio + (1.0 - ratio) * torch.clamp(normal @ light_d, min=0.0)
    lam = lam[..., None].expand(albedo.shape)
    return albedo * lam if code == SHADING_LAMBERTIAN else lam


class _BaseNeRF(nn.Module):
    """What the fields share (dreamfusion_tpu/models/networks.py:104-156).
    Subclasses define ``common(x) -> (sigma, albedo)`` and
    ``raw_normal(x)``, and call ``_init_bg_net`` after building their own
    modules."""

    def __init__(self, bound: float = 1.0, bg_radius: float = 1.4):
        super().__init__()
        self.bound = bound
        self.bg_radius = bg_radius
        self.bg_net = None

    def _init_bg_net(self, num_layers_bg: int, hidden_dim_bg: int,
                     dtype: torch.dtype) -> None:
        if self.bg_radius > 0:
            self.bg_net = MLP(freq_output_dim(3, 6), 3, hidden_dim_bg,
                              num_layers_bg, dtype)

    def density(self, x: torch.Tensor):
        sigma, albedo = self.common(x)
        return {"sigma": sigma, "albedo": albedo}

    def background(self, d: torch.Tensor) -> torch.Tensor:
        """Frequency-encoded MLP on ray directions, sigmoid rgb."""
        return torch.sigmoid(self.bg_net(freq_encode(d, degree=6)))

    def normal(self, x: torch.Tensor) -> torch.Tensor:
        n = safe_normalize(self.raw_normal(x))
        return torch.where(torch.isnan(n), torch.zeros_like(n), n)


class NeRFGridNetwork(_BaseNeRF):
    """Grid backbone (reference nerf/network_grid.py:35-181)."""

    def __init__(self, bound: float = 1.0, bg_radius: float = 1.4,
                 num_layers: int = 3, hidden_dim: int = 64,
                 num_layers_bg: int = 2, hidden_dim_bg: int = 64,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(bound, bg_radius)
        self.enc_spec = GridEncoderSpec(
            input_dim=3, num_levels=16, level_dim=2, base_resolution=16,
            log2_hashmap_size=16, desired_resolution=2048 * bound,
            gridtype="tiled")
        self.embeddings = nn.Parameter(
            torch.empty(self.enc_spec.table_size, 2))
        self.sigma_net = MLP(self.enc_spec.output_dim, 4, hidden_dim,
                             num_layers, compute_dtype)
        self._init_bg_net(num_layers_bg, hidden_dim_bg, compute_dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.embeddings.copy_(self.enc_spec.init(
                generator, self.embeddings.device))
        self.sigma_net.reset_parameters(generator)
        if self.bg_net is not None:
            self.bg_net.reset_parameters(generator)

    def common(self, x: torch.Tensor):
        """x [N,3] in [-bound,bound] -> (sigma [N], albedo [N,3])."""
        h = self.sigma_net(self.enc_spec(self.embeddings, x, bound=self.bound))
        sigma = trunc_exp(h[..., 0] + gaussian_blob(x))
        albedo = torch.sigmoid(h[..., 1:4])
        return sigma, albedo

    def raw_normal(self, x: torch.Tensor, epsilon: float = 1e-2):
        """-grad sigma by central differences (network_grid.py:90-105)."""
        grads = []
        for d in range(3):
            e = torch.zeros(1, 3, device=x.device)
            e[0, d] = epsilon
            s_p, _ = self.common(torch.clamp(x + e, -self.bound, self.bound))
            s_m, _ = self.common(torch.clamp(x - e, -self.bound, self.bound))
            grads.append(0.5 * (s_p - s_m) / epsilon)
        return -torch.stack(grads, dim=-1)


class FieldFns(NamedTuple):
    """The renderer's view of a field."""
    field: Callable
    background: Optional[Callable]


def make_field_fns(model: _BaseNeRF) -> FieldFns:
    """field(x, d, light_d, ratio, shading_code) -> (sigma, color, normal);
    the albedo code never evaluates normals (network_grid.py:123-127)."""

    def field(x, d, light_d, ratio, shading_code):
        sigma, albedo = model.common(x)
        if int(shading_code) == SHADING_ALBEDO:
            return sigma, albedo, torch.zeros_like(x)
        n = model.normal(x)
        return sigma, _shade(albedo, n, light_d, float(ratio),
                             shading_code), n

    background = model.background if model.bg_radius > 0 else None
    return FieldFns(field=field, background=background)
