"""DVGO's ResMLP colour decoder (frameworks/nerf/decoders/mlps.py:36-51),
in plain PyTorch for the benchmark's reference."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dfref.models.networks import lecun_normal_


def get_MLP(model_name: str, **kwargs):
    """The decoder by its registered name (reference: mlps.py:19-20)."""
    if model_name.lower() != "resmlp":
        raise KeyError(f"the reference holds the ResMLP decoder only, not "
                       f"{model_name!r}")
    return ResMLP(**kwargs)


class _Decoder(nn.Module):
    """flax's Dense initialisation for every Linear: lecun-normal weights,
    zero biases (the final bias is zero in the reference too)."""

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        for m in self.modules():
            if isinstance(m, nn.Linear):
                if m.in_features:
                    lecun_normal_(m.weight, m.in_features, generator)
                nn.init.zeros_(m.bias)


class Res1D(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.net = nn.Linear(width, width)

    def forward(self, x):
        return F.relu(self.net(x)) + x


class ResMLP(_Decoder):
    """Linear-ReLU + (depth-2) residual blocks + Linear, zero final bias
    (reference: decoders/mlps.py:36-51)."""

    def __init__(self, in_dim: int = 0, out_dim: int = 3, width: int = 128,
                 depth: int = 3):
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
