"""NeRF field networks (counterpart of
dreamfusion_tpu/models/networks.py; reference nerf/network_grid.py).

``_BaseNeRF`` holds what every field shares (density, background, the
normalise-and-NaN rule of the normal); ``NeRFGridNetwork`` is the grid
backbone, ``NeRFVanillaNetwork`` the vanilla backbone (reference
nerf/network.py: frequency encoding, a 5 x 128 ResMLP, autograd normals),
``models/kailu.DVGOEditNetwork`` the editing field, and ``build_model``
dispatches on ``cfg.backbone``.

Grid backbone: tiled grid encoder (L=16, C=2, 2^16 table per level,
desired resolution 2048*bound) + 3x64 ReLU MLP -> (sigma, albedo),
gaussian density blob, trunc_exp, frequency-encoded 2x64 background MLP,
finite-difference normals. Under ``fp16`` the MLPs compute in bf16 with f32 parameters, as
flax ``Dense(dtype=bf16)`` does in the JAX package.

Shading codes: 0 albedo, 1 lambertian, 2 textureless, 3 normal.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dreamfusion_torch.cameras import safe_normalize
from dreamfusion_torch.device import resolve_device
from dreamfusion_torch.ops.activation import trunc_exp
from dreamfusion_torch.ops.encoders import freq_encode, freq_output_dim
from dreamfusion_torch.ops.grid_encoder import GridEncoderSpec

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

    # whether common / raw_normal / normal take table_bf16 (a field with a
    # grid-encoder table)
    has_table = False

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

    def normal(self, x: torch.Tensor, **kw) -> torch.Tensor:
        n = safe_normalize(self.raw_normal(x, **kw))
        return torch.where(torch.isnan(n), torch.zeros_like(n), n)


class NeRFGridNetwork(_BaseNeRF):
    """Grid backbone (reference nerf/network_grid.py:35-181)."""

    has_table = True

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

    def encode(self, x: torch.Tensor, table_bf16: bool = False) -> torch.Tensor:
        emb = self.embeddings
        if table_bf16:
            emb = emb.to(torch.bfloat16)
        return self.enc_spec(emb, x, bound=self.bound)

    def common(self, x: torch.Tensor, table_bf16: bool = False):
        """x [N,3] in [-bound,bound] -> (sigma [N], albedo [N,3])."""
        h = self.sigma_net(self.encode(x, table_bf16))
        sigma = trunc_exp(h[..., 0] + gaussian_blob(x))
        albedo = torch.sigmoid(h[..., 1:4])
        return sigma, albedo

    def raw_normal(self, x: torch.Tensor, epsilon: float = 1e-2,
                   table_bf16: bool = False):
        """-grad sigma by central differences (network_grid.py:90-105)."""
        grads = []
        for d in range(3):
            e = torch.zeros(1, 3, device=x.device)
            e[0, d] = epsilon
            s_p, _ = self.common(torch.clamp(x + e, -self.bound, self.bound),
                                 table_bf16)
            s_m, _ = self.common(torch.clamp(x - e, -self.bound, self.bound),
                                 table_bf16)
            grads.append(0.5 * (s_p - s_m) / epsilon)
        return -torch.stack(grads, dim=-1)


class ResBlock(nn.Module):
    """Linear -> LayerNorm -> + skip -> SiLU (reference network.py:13-41).
    The skip is a bias-free Linear, present only where the widths differ.
    LayerNorm's epsilon is flax's 1e-6, not torch's default 1e-5."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.dense = nn.Linear(dim_in, dim_out)
        self.norm = nn.LayerNorm(dim_out, eps=1e-6)
        self.skip = (nn.Linear(dim_in, dim_out, bias=False)
                     if dim_in != dim_out else None)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        lecun_normal_(self.dense.weight, self.dense.in_features, generator)
        nn.init.zeros_(self.dense.bias)
        self.norm.reset_parameters()
        if self.skip is not None:
            lecun_normal_(self.skip.weight, self.skip.in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(self.dense(x))
        return F.silu(h + (x if self.skip is None else self.skip(x)))


class ResMLP(nn.Module):
    """(num_layers - 1) ResBlocks named block_0.. and a final Linear
    dense_out (reference network.py:44-67); float32 throughout."""

    def __init__(self, dim_in: int, dim_out: int, dim_hidden: int,
                 num_layers: int):
        super().__init__()
        self.num_blocks = num_layers - 1
        for l in range(self.num_blocks):
            self.add_module(f"block_{l}", ResBlock(
                dim_in if l == 0 else dim_hidden, dim_hidden))
        self.dense_out = nn.Linear(dim_hidden, dim_out)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for l in range(self.num_blocks):
            getattr(self, f"block_{l}").reset_parameters(generator)
        lecun_normal_(self.dense_out.weight, self.dense_out.in_features,
                      generator)
        nn.init.zeros_(self.dense_out.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for l in range(self.num_blocks):
            x = getattr(self, f"block_{l}")(x)
        return self.dense_out(x)


class NeRFVanillaNetwork(_BaseNeRF):
    """Vanilla backbone (reference nerf/network.py:70-221): frequency
    encoding of degree 6 (39 dims) into a 5 x 128 ResMLP, float32 even
    under fp16, as in the JAX package (networks.py:226); the background MLP
    is float32 too (the JAX module builds it without a dtype). Normals are
    -d(sum sigma)/dx by autograd (network.py:135-146)."""

    def __init__(self, bound: float = 1.0, bg_radius: float = 1.4,
                 num_layers: int = 5, hidden_dim: int = 128,
                 num_layers_bg: int = 2, hidden_dim_bg: int = 64):
        super().__init__(bound, bg_radius)
        self.sigma_net = ResMLP(freq_output_dim(3, 6), 4, hidden_dim,
                                num_layers)
        self._init_bg_net(num_layers_bg, hidden_dim_bg, torch.float32)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.sigma_net.reset_parameters(generator)
        if self.bg_net is not None:
            self.bg_net.reset_parameters(generator)

    def common(self, x: torch.Tensor):
        """x [N,3] in [-bound,bound] -> (sigma [N], albedo [N,3])."""
        h = self.sigma_net(freq_encode(x, degree=6))
        sigma = trunc_exp(h[..., 0] + gaussian_blob(x))
        albedo = torch.sigmoid(h[..., 1:4])
        return sigma, albedo

    def raw_normal(self, x: torch.Tensor) -> torch.Tensor:
        """-d(sum sigma)/dx (networks.py:233-238). In training the graph is
        kept (create_graph), so the normal carries its second-order term to
        the parameters, as the JAX package's vjp inside value_and_grad
        does; under no_grad (the eval) the gradient is taken all the same
        and nothing is kept."""
        keep = torch.is_grad_enabled()
        with torch.enable_grad():
            p = x if x.requires_grad else x.detach().requires_grad_(True)
            sigma, _ = self.common(p)
            (gx,) = torch.autograd.grad(sigma.sum(), p, create_graph=keep)
        return -gx


class FieldFns(NamedTuple):
    """The renderers' view of a field (dreamfusion_tpu/renderer.py
    FieldFns). density feeds the stratified renderer's coarse pass; the
    occupancy refresh calls model.density directly."""
    field: Callable
    density: Callable
    background: Optional[Callable]
    normal: Optional[Callable]


def make_field_fns(model: _BaseNeRF, bg: bool = True,
                   table_bf16: bool = False) -> FieldFns:
    """field(x, d, light_d, ratio, shading_code) -> (sigma, color, normal);
    the albedo code never evaluates normals (network_grid.py:123-127).
    table_bf16: every table gather of these functions reads the bf16 view
    (the JAX package's model.clone(table_bf16=True)); it applies only to a
    field that has a table (dreamfusion_tpu/training/trainer.py:276-278)."""
    kw = {"table_bf16": True} if table_bf16 and model.has_table else {}

    def field(x, d, light_d, ratio, shading_code):
        sigma, albedo = model.common(x, **kw)
        if int(shading_code) == SHADING_ALBEDO:
            return sigma, albedo, torch.zeros_like(x)
        n = model.normal(x, **kw)
        return sigma, _shade(albedo, n, light_d, float(ratio),
                             shading_code), n

    def density(x):
        sigma, albedo = model.common(x, **kw)
        return {"sigma": sigma, "albedo": albedo}

    def normal(x):
        return model.normal(x, **kw)

    background = None
    if bg and model.bg_radius > 0:
        background = model.background
    return FieldFns(field=field, density=density, background=background,
                    normal=normal)


def build_model(cfg, device: Optional[torch.device] = None,
                generator: Optional[torch.Generator] = None) -> _BaseNeRF:
    """Backbone dispatch (reference main.py:86-94, and the editing path
    main.py:100-102 through backbone "dvgo"). Weights are drawn from the
    generator; a pretrained .dvgo file is loaded by the Trainer."""
    if cfg.backbone == "grid":
        dtype = torch.bfloat16 if cfg.fp16 else torch.float32
        model = NeRFGridNetwork(bound=cfg.bound, bg_radius=cfg.bg_radius,
                                compute_dtype=dtype)
    elif cfg.backbone == "vanilla":
        model = NeRFVanillaNetwork(bound=cfg.bound, bg_radius=cfg.bg_radius)
    elif cfg.backbone == "dvgo":
        from dreamfusion_torch.models.kailu import DVGOEditNetwork

        model = DVGOEditNetwork.from_config(cfg)
    else:
        raise NotImplementedError(
            f"backbone {cfg.backbone!r} not implemented (choose from grid, "
            "vanilla, dvgo)")
    model = model.to(resolve_device(device))
    model.reset_parameters(generator)
    return model
