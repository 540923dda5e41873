"""Registered MLP decoders of the DVGO family (counterpart of
dreamfusion_tpu/models/decoders.py; reference
frameworks/nerf/decoders/mlps.py): a string registry of colour decoder
MLPs. Modules carry the flax names (dense_in, res_i.net, dense_out,
dense_i, rgb_i, shadow_out, shadowNet, map_i, net_i, net1_i, ...), so
``weights.from_jax_params`` converts their trees mechanically.

flax sizes a Dense from the tensor it receives; an nn.Linear is sized when
it is built. So ``in_dim`` is the width of the input the field feeds the
decoder, and each Linear's width is that of the slice of it the flax
module reads (``_width``). The ShadowMLP family of the OSR fields
registers here on import of models/osr.py, as in the JAX package.

The noise ensembles of RobustShadowMLP and RobustMLP take their draws as
a tensor: ``noise`` [ensemble, ..., features] of standard normals (the
JAX package's ``noise_key``, split once per member).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dreamfusion_torch.models.networks import lecun_normal_

model_dict: Dict[str, Callable] = {}


def register_model(cls):
    key = cls.__name__.lower()
    if key in model_dict and model_dict[key] is not cls:
        raise KeyError(f"duplicated decoder key {key}")
    model_dict[key] = cls
    return cls


def get_MLP(model_name: str, **kwargs):
    """(reference: decoders/mlps.py:19-20)"""
    return model_dict[model_name.lower()](**kwargs)


class _Decoder(nn.Module):
    """flax's Dense initialisation for every Linear: lecun-normal weights,
    zero biases (the final bias is zero in the reference too)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, nn.Linear):
                if m.in_features:
                    lecun_normal_(m.weight, m.in_features, generator)
                nn.init.zeros_(m.bias)


def _width(in_dim: int, sl: slice) -> int:
    """The width of x[..., sl] for an input of in_dim features (Python's
    slice rules, as the flax modules read their inputs)."""
    return len(range(in_dim)[sl])


def _add_stack(module: nn.Module, name: str, in_w: int, width: int,
               depth: int, out: int) -> None:
    """The Linears of the JAX package's _mlp_stack: {name}_i for i <
    depth - 1 and {name}_out."""
    for i in range(depth - 1):
        module.add_module(f"{name}_{i}", nn.Linear(in_w if i == 0 else width,
                                                   width))
    module.add_module(f"{name}_out",
                      nn.Linear(in_w if depth == 1 else width, out))


def _run_stack(module: nn.Module, name: str, x: torch.Tensor,
               depth: int) -> torch.Tensor:
    """Linear-ReLU x (depth - 1) + Linear(out) (decoders.py _mlp_stack)."""
    for i in range(depth - 1):
        x = F.relu(getattr(module, f"{name}_{i}")(x))
    return getattr(module, f"{name}_out")(x)


class Res1D(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.net = nn.Linear(width, width)

    def forward(self, x):
        return F.relu(self.net(x)) + x


@register_model
class ResMLP(_Decoder):
    """Linear-ReLU + (depth-2) residual blocks + Linear, zero final bias
    (reference: decoders/mlps.py:36-51)."""

    def __init__(self, in_dim: int = 0, out_dim: int = 3, width: int = 128,
                 depth: int = 3, k0_dim: int = 0):
        super().__init__()
        self.depth = depth
        self.dense_in = nn.Linear(in_dim, width)
        for i in range(depth - 2):
            self.add_module(f"res_{i}", Res1D(width))
        self.dense_out = nn.Linear(width, out_dim)
        self.reset_parameters()

    def forward(self, x):
        h = F.relu(self.dense_in(x))
        for i in range(self.depth - 2):
            h = getattr(self, f"res_{i}")(h)
        return self.dense_out(h)


@register_model
class BasicMLP(_Decoder):
    """Plain ReLU MLP, zero final bias (reference: mlps.py:59-73)."""

    def __init__(self, in_dim: int = 0, out_dim: int = 3, width: int = 128,
                 depth: int = 3, k0_dim: int = 0):
        super().__init__()
        self.depth = depth
        self.dense_0 = nn.Linear(in_dim, width)
        for i in range(depth - 2):
            self.add_module(f"dense_{i + 1}", nn.Linear(width, width))
        self.dense_out = nn.Linear(width, out_dim)
        self.reset_parameters()

    def forward(self, x):
        h = x
        for i in range(self.depth - 1):
            h = F.relu(getattr(self, f"dense_{i}")(h))
        return self.dense_out(h)


# 'mlp' aliases BasicMLP (reference: mlps.py:54-56)
model_dict["mlp"] = BasicMLP


@register_model
class DirectShadowMLP(_Decoder):
    """rgb from the first k0_dim - 1 features; shadow read directly from
    the next feature channel (mlps.py:101-113)."""

    def __init__(self, in_dim: int = 0, out_dim: int = 4, width: int = 128,
                 depth: int = 3, k0_dim: int = 6):
        super().__init__()
        self.depth, self.kd = depth, k0_dim - 1
        _add_stack(self, "rgb", _width(in_dim, slice(None, self.kd)), width,
                   depth, 3)
        self.reset_parameters()

    def forward(self, x):
        rgb = _run_stack(self, "rgb", x[..., :self.kd], self.depth)
        return torch.cat([rgb, x[..., self.kd:self.kd + 1]], -1)


@register_model
class ShadowV3MLP(_Decoder):
    """rgb from the features after the shadow slice; shadow = Linear(the
    first shadow_dim features) (mlps.py:116-128)."""

    def __init__(self, in_dim: int = 0, out_dim: int = 4, width: int = 128,
                 depth: int = 3, k0_dim: int = 6, shadow_dim: int = 1):
        super().__init__()
        self.depth, self.shadow_dim = depth, shadow_dim
        _add_stack(self, "rgb", _width(in_dim, slice(shadow_dim, None)),
                   width, depth, 3)
        self.shadowNet = nn.Linear(_width(in_dim, slice(None, shadow_dim)), 1)
        self.reset_parameters()

    def forward(self, x):
        rgb = _run_stack(self, "rgb", x[..., self.shadow_dim:], self.depth)
        shadow = self.shadowNet(x[..., :self.shadow_dim])
        return torch.cat([rgb, shadow], -1)


@register_model
class ShadowV4MLP(_Decoder):
    """V3 with a 2 x 64 MLP shadow head (mlps.py:131-143)."""

    def __init__(self, in_dim: int = 0, out_dim: int = 4, width: int = 128,
                 depth: int = 3, k0_dim: int = 6, shadow_dim: int = 1):
        super().__init__()
        self.depth, self.shadow_dim = depth, shadow_dim
        _add_stack(self, "rgb", _width(in_dim, slice(shadow_dim, None)),
                   width, depth, 3)
        self.shadow_0 = nn.Linear(_width(in_dim, slice(None, shadow_dim)), 64)
        self.shadow_1 = nn.Linear(64, 64)
        self.shadow_out = nn.Linear(64, 1)
        self.reset_parameters()

    def forward(self, x):
        rgb = _run_stack(self, "rgb", x[..., self.shadow_dim:], self.depth)
        s = F.relu(self.shadow_0(x[..., :self.shadow_dim]))
        s = F.relu(self.shadow_1(s))
        return torch.cat([rgb, self.shadow_out(s)], -1)


class _SplitShadow(_Decoder):
    """The split of V5, RobustShadowMLP and ShadowRGIMLP: colour features
    x[..., shadow_dim:k0_dim]; shadow features the first shadow_dim and
    everything after k0_dim (the encodings)."""

    def _split(self, x):
        sd, kd = self.shadow_dim, self.k0_dim
        return x[..., sd:kd], torch.cat([x[..., :sd], x[..., kd:]], -1)

    @staticmethod
    def _split_widths(in_dim, shadow_dim, k0_dim):
        return (_width(in_dim, slice(shadow_dim, k0_dim)),
                _width(in_dim, slice(None, shadow_dim))
                + _width(in_dim, slice(k0_dim, None)))


@register_model
class ShadowV5MLP(_SplitShadow):
    """View-dependent shadow: rgb from features [shadow_dim:k0_dim]; a
    shadow MLP over (shadow features, encodings beyond k0)
    (mlps.py:147-169)."""

    def __init__(self, in_dim: int = 0, out_dim: int = 4, width: int = 128,
                 depth: int = 3, k0_dim: int = 6, shadow_dim: int = 1):
        super().__init__()
        self.depth, self.k0_dim, self.shadow_dim = depth, k0_dim, shadow_dim
        rgb_w, shadow_w = self._split_widths(in_dim, shadow_dim, k0_dim)
        _add_stack(self, "rgb", rgb_w, width, depth, 3)
        _add_stack(self, "shadow", shadow_w, width, depth, 1)
        self.reset_parameters()

    def forward(self, x):
        rgb_in, sfeat = self._split(x)
        return torch.cat([_run_stack(self, "rgb", rgb_in, self.depth),
                          _run_stack(self, "shadow", sfeat, self.depth)], -1)


def _ensemble(net, h, noise, scale):
    """The mean of net over the ensemble's noisy copies of h, or net(h)
    without draws. noise: [ensemble, *h.shape] standard normals."""
    if noise is None:
        return net(h)
    return sum(net(h + n * scale) for n in noise) / noise.shape[0]


@register_model
class RobustShadowMLP(_SplitShadow):
    """V5 with a train-time noise ensemble on the rgb features
    (mlps.py:172-202); pass ``noise`` to enable it."""

    def __init__(self, in_dim: int = 0, out_dim: int = 4, width: int = 128,
                 depth: int = 3, k0_dim: int = 6, shadow_dim: int = 1,
                 ensemble: int = 2, noise_beta: float = 0.1):
        super().__init__()
        self.depth, self.k0_dim, self.shadow_dim = depth, k0_dim, shadow_dim
        self.ensemble, self.noise_beta = ensemble, noise_beta
        rgb_w, shadow_w = self._split_widths(in_dim, shadow_dim, k0_dim)
        _add_stack(self, "shadow", shadow_w, width, depth, 1)
        _add_stack(self, "rgb", rgb_w, width, depth, 3)
        self.reset_parameters()

    def forward(self, x, noise: Optional[torch.Tensor] = None):
        rgb_in, sfeat = self._split(x)
        shadow = _run_stack(self, "shadow", sfeat, self.depth)
        rgb = _ensemble(lambda h: _run_stack(self, "rgb", h, self.depth),
                        rgb_in, noise, self.noise_beta)
        return torch.cat([rgb, shadow], -1)


@register_model
class ShadowRGIMLP(_SplitShadow):
    """(r, g) chromaticity head + luminance head (mlps.py:205-230)."""

    def __init__(self, in_dim: int = 0, out_dim: int = 3, width: int = 128,
                 depth: int = 3, k0_dim: int = 6, shadow_dim: int = 1):
        super().__init__()
        self.depth, self.k0_dim, self.shadow_dim = depth, k0_dim, shadow_dim
        rg_w, lum_w = self._split_widths(in_dim, shadow_dim, k0_dim)
        _add_stack(self, "rg", rg_w, width, depth, 2)
        _add_stack(self, "lum", lum_w, width, depth, 1)
        self.reset_parameters()

    def forward(self, x):
        rg_in, sfeat = self._split(x)
        return torch.cat([_run_stack(self, "rg", rg_in, self.depth),
                          _run_stack(self, "lum", sfeat, self.depth)], -1)


@register_model
class DVP_MLP(_Decoder):
    """BasicMLP with a 2-layer mapping network on the k0 features
    (mlps.py:256-269)."""

    def __init__(self, in_dim: int = 0, out_dim: int = 3, width: int = 128,
                 depth: int = 3, k0_dim: int = 0):
        super().__init__()
        self.depth, self.k0_dim = depth, k0_dim
        kw = _width(in_dim, slice(None, k0_dim))
        self.map_0 = nn.Linear(kw, k0_dim)
        self.map_1 = nn.Linear(k0_dim, k0_dim)
        _add_stack(self, "net", k0_dim + _width(in_dim, slice(k0_dim, None)),
                   width, depth, out_dim)
        self.reset_parameters()

    def forward(self, x):
        k0 = self.map_1(F.relu(self.map_0(x[..., :self.k0_dim])))
        h = torch.cat([k0, x[..., self.k0_dim:]], -1)
        return _run_stack(self, "net", h, self.depth)


@register_model
class RobustMLP(_Decoder):
    """BasicMLP with clamped features and a train-time noise ensemble on
    them (mlps.py:272-292); pass ``noise`` ([ensemble, ..., k0 features])
    to enable it."""

    def __init__(self, in_dim: int = 0, out_dim: int = 3, width: int = 128,
                 depth: int = 3, k0_dim: int = 0, ensemble: int = 2,
                 noise_beta: float = 0.1):
        super().__init__()
        self.depth, self.k0_dim = depth, k0_dim
        self.ensemble, self.noise_beta = ensemble, noise_beta
        _add_stack(self, "net", in_dim, width, depth, out_dim)
        self.reset_parameters()

    def forward(self, x, noise: Optional[torch.Tensor] = None):
        kd = self.k0_dim
        x = torch.cat([torch.clamp(x[..., :kd], -1, 1), x[..., kd:]], -1)
        if noise is not None:     # the noise covers the k0 features only
            noise = F.pad(noise, (0, x.shape[-1] - noise.shape[-1]))
        return _ensemble(lambda h: _run_stack(self, "net", h, self.depth),
                         x, noise, self.noise_beta)


@register_model
class LIIF_MLP(_Decoder):
    """Joint (colour, density) LIIF decoder: a view-independent trunk whose
    last hidden unit is the density, and a view-conditioned colour head
    (mlps.py:296-316)."""

    def __init__(self, in_dim: int = 0, out_dim: int = 4, width: int = 128,
                 depth: int = 3, viewdir_dim: int = 0, k0_dim: int = 0):
        super().__init__()
        self.depth, self.viewdir_dim = depth, viewdir_dim
        self.net1_0 = nn.Linear(_width(in_dim, slice(None, -viewdir_dim)),
                                width)
        for i in range(depth - 3):
            self.add_module(f"net1_{i + 1}", nn.Linear(width, width))
        view_w = _width(in_dim, slice(-viewdir_dim, None))
        self.net2_0 = nn.Linear(width + view_w, width)
        self.net2_out = nn.Linear(width, out_dim - 1)
        self.reset_parameters()

    def forward(self, x):
        v = self.viewdir_dim
        emb, view = x[..., :-v], x[..., -v:]
        h = F.relu(self.net1_0(emb))
        for i in range(self.depth - 3):
            h = F.relu(getattr(self, f"net1_{i + 1}")(h))
        c = F.relu(self.net2_0(torch.cat([h, view], -1)))
        return torch.cat([self.net2_out(c), h[..., -1:]], -1)
