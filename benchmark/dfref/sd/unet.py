# Plain PyTorch for the benchmark's reference, after the program's
# dreamfusion_torch/guidance/sd/unet.py; it imports nothing of the program.
"""UNet2DCondition, Stable Diffusion v1.x geometry (counterpart of
dreamfusion_tpu/guidance/sd/unet.py).

NCHW inside; the public ``forward`` keeps the JAX layout: latents
[B,H,W,4] in, eps [B,H,W,4] f32 out. Submodule names follow the JAX
package's flax names (down_blocks_0_resnets_1/conv1, ...), so
``weights.from_jax_params`` is a mechanical rename. Linear layers and
convolutions compute in the dtype their weights are stored in (bf16 for
the full model under -O); GroupNorm and LayerNorm parameters stay f32 and
their statistics are f32.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dfref.sd.layers import GroupNorm, attention_core


class Linear(nn.Linear):
    """nn.Linear that casts its input to its weight dtype (flax Dense(dtype))."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class Conv2d(nn.Conv2d):
    """nn.Conv2d that casts its input to its weight dtype."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class LayerNorm(nn.LayerNorm):
    """f32 LayerNorm with flax's default epsilon 1e-6."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding, diffusers convention (flip_sin_to_cos=True,
    freq_shift=0): [cos, sin]."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half
    args = t.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], -1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample):
        return self.linear_2(F.silu(self.linear_1(sample)))


class ResnetBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int = 0, groups: int = 32, eps: float = 1e-5):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, eps)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (Linear(temb_channels, out_channels)
                              if temb_channels else None)
        self.norm2 = GroupNorm(out_channels, groups, eps)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb=None):
        dtype = self.conv1.weight.dtype
        h = self.conv1(F.silu(self.norm1(x)).to(dtype))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)).to(dtype))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Attention(nn.Module):
    def __init__(self, query_dim: int, context_dim: int, heads: int,
                 head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out_0 = Linear(inner, query_dim)

    def forward(self, x, context=None):
        context = x if context is None else context
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        B, Nq, _ = q.shape
        Nk = k.shape[1]
        q = q.reshape(B, Nq, self.heads, self.head_dim)
        k = k.reshape(B, Nk, self.heads, self.head_dim)
        v = v.reshape(B, Nk, self.heads, self.head_dim)
        out = attention_core(q, k, v, 1.0 / math.sqrt(self.head_dim),
                             self.to_q.weight.dtype)
        return self.to_out_0(out.reshape(B, Nq, -1))


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim, dim_out * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate, approximate="tanh")   # flax nn.gelu default


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net_0 = GEGLU(dim, dim * 4)
        self.net_2 = Linear(dim * 4, dim)

    def forward(self, x):
        return self.net_2(self.net_0(x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, dim, heads, dim // heads)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, context_dim, heads, dim // heads)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        dtype = self.attn1.to_q.weight.dtype
        x = x + self.attn1(self.norm1(x).to(dtype))
        x = x + self.attn2(self.norm2(x).to(dtype), context)
        return x + self.ff(self.norm3(x).to(dtype))


class Transformer2D(nn.Module):
    def __init__(self, channels: int, context_dim: int, heads: int):
        super().__init__()
        self.norm = GroupNorm(channels, 32, 1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks_0 = BasicTransformerBlock(channels,
                                                          context_dim, heads)
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.transformer_blocks_0(h, context)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


class Downsample2D(nn.Module):
    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = Conv2d(channels, channels, 3, stride=2,
                           padding=0 if asymmetric_pad else 1)

    def forward(self, x):
        if self.asymmetric_pad:       # VAE encoder: pad (0,1) on H and W
            x = F.pad(x, (0, 1, 0, 1))
        return self.conv(x)


class Upsample2D(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UNet2DCondition(nn.Module):
    """SD v1.x UNet: forward(latents [B,H,W,4], t [B], context [B,77,D])."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, attention_heads: int = 8,
                 cross_attention_dim: int = 768):
        super().__init__()
        ch = list(block_out_channels)
        self.block_out_channels = ch
        self.layers_per_block = layers_per_block
        self.cross_attention_dim = cross_attention_dim
        n = len(ch)
        temb_dim = ch[0] * 4
        heads, ctx = attention_heads, cross_attention_dim
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        self.conv_in = Conv2d(in_channels, ch[0], 3, padding=1)

        skip_ch = [ch[0]]
        cur = ch[0]
        for i in range(n):
            last = i == n - 1
            for j in range(layers_per_block):
                self.add_module(f"down_blocks_{i}_resnets_{j}",
                                ResnetBlock2D(cur, ch[i], temb_dim))
                cur = ch[i]
                if not last:
                    self.add_module(f"down_blocks_{i}_attentions_{j}",
                                    Transformer2D(cur, ctx, heads))
                skip_ch.append(cur)
            if not last:
                self.add_module(f"down_blocks_{i}_downsamplers_0",
                                Downsample2D(cur))
                skip_ch.append(cur)

        self.mid_block_resnets_0 = ResnetBlock2D(cur, ch[-1], temb_dim)
        self.mid_block_attentions_0 = Transformer2D(ch[-1], ctx, heads)
        self.mid_block_resnets_1 = ResnetBlock2D(ch[-1], ch[-1], temb_dim)
        cur = ch[-1]

        for i in range(n):
            out_ch = ch[::-1][i]
            for j in range(layers_per_block + 1):
                self.add_module(f"up_blocks_{i}_resnets_{j}",
                                ResnetBlock2D(cur + skip_ch.pop(), out_ch,
                                              temb_dim))
                cur = out_ch
                if i != 0:
                    self.add_module(f"up_blocks_{i}_attentions_{j}",
                                    Transformer2D(cur, ctx, heads))
            if i != n - 1:
                self.add_module(f"up_blocks_{i}_upsamplers_0", Upsample2D(cur))

        self.conv_norm_out = GroupNorm(cur, 32, 1e-5)
        self.conv_out = Conv2d(cur, out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context):
        ch = self.block_out_channels
        n = len(ch)
        dtype = self.conv_in.weight.dtype
        temb = self.time_embedding(timestep_embedding(timesteps, ch[0]))
        temb = temb.to(dtype)
        context = context.to(dtype)
        h = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [h]
        for i in range(n):
            last = i == n - 1
            for j in range(self.layers_per_block):
                h = getattr(self, f"down_blocks_{i}_resnets_{j}")(h, temb)
                if not last:
                    h = getattr(self, f"down_blocks_{i}_attentions_{j}")(
                        h, context)
                skips.append(h)
            if not last:
                h = getattr(self, f"down_blocks_{i}_downsamplers_0")(h)
                skips.append(h)
        h = self.mid_block_resnets_0(h, temb)
        h = self.mid_block_attentions_0(h, context)
        h = self.mid_block_resnets_1(h, temb)
        for i in range(n):
            for j in range(self.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_blocks_{i}_resnets_{j}")(h, temb)
                if i != 0:
                    h = getattr(self, f"up_blocks_{i}_attentions_{j}")(
                        h, context)
            if i != n - 1:
                h = getattr(self, f"up_blocks_{i}_upsamplers_0")(h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)).to(dtype))
        return h.float().permute(0, 2, 3, 1)


