"""Frequency (positional) encoding for the background MLP
(counterpart of dreamfusion_tpu/ops/encoders.py::freq_encode)."""

from __future__ import annotations

import torch


def freq_encode(x: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^{deg-1} x), cos(2^{deg-1} x)]
    (layout of freqencoder/src/freqencoder.cu:30-58)."""
    x = x.float()
    outs = [x]
    for f in range(degree):
        sx = x * (2.0 ** f)
        outs.append(torch.sin(sx))
        outs.append(torch.cos(sx))
    return torch.cat(outs, dim=-1)


def freq_output_dim(input_dim: int, degree: int) -> int:
    return input_dim + 2 * input_dim * degree
