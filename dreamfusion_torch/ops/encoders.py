"""Input encoders: frequency (positional), real spherical harmonics, and
the encoder factory (counterpart of dreamfusion_tpu/ops/encoders.py;
reference freqencoder/, shencoder/, encoding.py). Both parameter-free
encoders are small elementwise expressions in plain PyTorch, as they are
plain JAX in the JAX package; autograd gives their backward passes."""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, Tuple

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


# Real SH basis with Condon-Shortley phase, the convention of the
# reference's polynomial table (shencoder/src/shencoder.cu:28-356), built
# from Cartesian recurrences:
#   A_m + i B_m = (x + i y)^m
#   Pb_m^m = (-1)^m (2m-1)!!,  Pb_{m+1}^m = z (2m+1) Pb_m^m,
#   Pb_l^m = ((2l-1) z Pb_{l-1}^m - (l+m-1) Pb_{l-2}^m) / (l - m),
#   Y_{l,m>0} = sqrt(2) K_l^m Pb_l^m A_m,  Y_{l,-m} = sqrt(2) K_l^m Pb_l^m B_m,
#   Y_{l,0} = K_l^0 Pb_l^0,  K_l^m = sqrt((2l+1)/(4 pi) (l-m)!/(l+m)!).
# Ordering: index l^2 + l + m for m in [-l, l].

def _sh_norm(l: int, m: int) -> float:
    return math.sqrt((2 * l + 1) / (4 * math.pi)
                     * math.factorial(l - m) / math.factorial(l + m))


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Real SH basis values of unit directions [..., 3] -> [..., degree^2];
    degree in [1, 8] (shencoder/sphere_harmonics.py:67-68)."""
    if not 1 <= degree <= 8:
        raise ValueError(f"SH degree must be in [1, 8], got {degree}")
    x, y, z = (dirs[..., i].float() for i in range(3))
    L = degree
    A, B = [torch.ones_like(x)], [torch.zeros_like(x)]
    for m in range(1, L):
        A.append(x * A[m - 1] - y * B[m - 1])
        B.append(x * B[m - 1] + y * A[m - 1])

    Pb = [[None] * L for _ in range(L)]
    for m in range(L):
        pmm = 1.0
        for k in range(1, m + 1):
            pmm *= -(2 * k - 1)
        Pb[m][m] = torch.full_like(z, pmm)
        if m + 1 < L:
            Pb[m + 1][m] = z * (2 * m + 1) * Pb[m][m]
        for l in range(m + 2, L):
            Pb[l][m] = ((2 * l - 1) * z * Pb[l - 1][m]
                        - (l + m - 1) * Pb[l - 2][m]) / (l - m)

    out = []
    for l in range(L):
        row = [None] * (2 * l + 1)
        row[l] = _sh_norm(l, 0) * Pb[l][0]
        for m in range(1, l + 1):
            c = math.sqrt(2.0) * _sh_norm(l, m)
            row[l + m] = c * Pb[l][m] * A[m]
            row[l - m] = c * Pb[l][m] * B[m]
        out.extend(row)
    return torch.stack(out, dim=-1)


def sh_output_dim(degree: int) -> int:
    return degree * degree


def get_encoder(encoding: str, input_dim: int = 3, multires: int = 6,
                degree: int = 4, **grid_kwargs
                ) -> Tuple[Callable[..., torch.Tensor], int]:
    """String -> (encode fn, output_dim) (reference encoding.py:5-33).

    'None' | 'frequency' | 'sphere_harmonics' are parameter-free functions.
    'hashgrid' | 'tiledgrid' return a GridEncoderSpec, called as
    spec(table, x, bound) with a table from spec.init()."""
    if encoding == "None":
        return (lambda x, **kw: x), input_dim
    if encoding == "frequency":
        return (partial(freq_encode, degree=multires),
                freq_output_dim(input_dim, multires))
    if encoding == "sphere_harmonics":
        return partial(sh_encode, degree=degree), sh_output_dim(degree)
    if encoding in ("hashgrid", "tiledgrid"):
        from dreamfusion_torch.ops.grid_encoder import GridEncoderSpec

        spec = GridEncoderSpec(
            input_dim=input_dim,
            gridtype="hash" if encoding == "hashgrid" else "tiled",
            **grid_kwargs)
        return spec, spec.output_dim
    raise NotImplementedError(
        "Unknown encoding, choose from [None, frequency, sphere_harmonics, "
        f"hashgrid, tiledgrid]; got {encoding!r}")
