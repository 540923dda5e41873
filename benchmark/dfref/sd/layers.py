# Plain PyTorch for the benchmark's reference, after the program's
# dreamfusion_torch/guidance/sd/layers.py; it imports nothing of the program.
"""Building blocks shared by the SD UNet and VAE, NCHW, in plain PyTorch
for the benchmark's reference.

``GroupNorm``: statistics in f32 by the one-pass E[x^2] - E[x]^2; the
normalised output is bf16 when ``GN_DTYPE`` is "bf16", else f32.

``attention_core``: softmax(q k^T * scale) v. bf16 self-attention over
N >= 2,048 (a multiple of 512: the UNet's and the VAE's attention over
64x64 latents), where the program takes its fused kernels, computes the
scores, the softmax and the sums in f32; every other call (and f32
inputs) a matmul in the inputs' type, an f32 softmax and a second
matmul.
"""

from __future__ import annotations

import torch
import torch.nn as nn

# Output dtype of GroupNorm: "bf16" as in the JAX package; the parity tests
# set "f32" to compare with the f32 oracle.
GN_DTYPE = "bf16"


class GroupNorm(nn.Module):
    """GroupNorm over NC... with f32 statistics; params ``weight``/``bias``
    [C] (flax's scale/bias)."""

    def __init__(self, num_channels: int, num_groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        assert num_channels % num_groups == 0, (num_channels, num_groups)
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        G = self.num_groups
        xf = x.float()
        g = xf.reshape(B, G, -1)
        mean = g.mean(-1)
        var = torch.clamp((g * g).mean(-1) - mean * mean, min=0.0)
        inv = torch.rsqrt(var + self.eps)
        bshape = (B, C) + (1,) * (x.ndim - 2)
        mean_c = mean.repeat_interleave(C // G, dim=1).reshape(bshape)
        inv_c = inv.repeat_interleave(C // G, dim=1).reshape(bshape)
        pshape = (1, C) + (1,) * (x.ndim - 2)
        y = (xf - mean_c) * inv_c
        y = y * self.weight.float().reshape(pshape) + \
            self.bias.float().reshape(pshape)
        return y.to(torch.bfloat16) if GN_DTYPE == "bf16" else y


# the JAX package's threshold for its flash branch (layers.py:103)
_FLASH_MIN_SEQ = 2048


def use_flash(Nq: int, Nk: int, dtype: torch.dtype) -> bool:
    return (Nq == Nk and Nq >= _FLASH_MIN_SEQ and Nq % 512 == 0
            and dtype == torch.bfloat16)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: float, dtype: torch.dtype) -> torch.Tensor:
    """[B, N, H, D] inputs -> [B, Nq, H, D]; scores and softmax in f32."""
    if use_flash(q.shape[1], k.shape[1], q.dtype):
        qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
        p = torch.softmax(torch.matmul(qf, kf.transpose(-1, -2)) * scale,
                          dim=-1)
        return torch.matmul(p, vf).transpose(1, 2).to(q.dtype).to(dtype)
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))   # [B, H, N, D]
    attn = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    attn = torch.softmax(attn.float(), dim=-1).to(dtype)
    return torch.matmul(attn, vh).transpose(1, 2)
