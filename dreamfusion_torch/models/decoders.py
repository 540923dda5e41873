"""Registered MLP decoders of the DVGO family (counterpart of
dreamfusion_tpu/models/decoders.py; reference
frameworks/nerf/decoders/mlps.py): a string registry of colour decoder
MLPs. Modules carry the flax names (dense_in, res_i.net, dense_out,
dense_i), so ``weights.from_jax_params`` converts their trees mechanically.
The shadow, DVP and LIIF decoders are not ported yet.
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
                lecun_normal_(m.weight, m.in_features, generator)
                nn.init.zeros_(m.bias)


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
