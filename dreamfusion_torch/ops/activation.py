"""Density activation with a truncated-gradient exponential
(counterpart of dreamfusion_tpu/ops/activation.py; reference activation.py:5-16).

Forward: exp in float32. Backward: the saved input is clamped to [-15, 15]
so large densities cannot give inf gradients.
"""

from __future__ import annotations

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x32 = x.float()
        ctx.save_for_backward(x32)
        return torch.exp(x32)

    @staticmethod
    def backward(ctx, g):
        (x32,) = ctx.saved_tensors
        return g.float() * torch.exp(torch.clamp(x32, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)
