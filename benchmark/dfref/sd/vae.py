# Plain PyTorch for the benchmark's reference, after the program's
# dreamfusion_torch/guidance/sd/vae.py; it imports nothing of the program.
"""AutoencoderKL, the SD VAE, in plain PyTorch for the benchmark's
reference. The encoder runs during SDS (with gradients, nerf/sd.py:156-164);
the decoder's layers are built, so that a seeded fill in module order
gives the encoder the program's weights, and never run. NCHW inside,
[B,H,W,C] at ``moments`` / ``encode``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dfref.sd.layers import GroupNorm, attention_core
from dfref.sd.unet import (Conv2d, Downsample2D, Linear, ResnetBlock2D,
                           Upsample2D)


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial positions (mid block)."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels, 32, 1e-6)
        self.to_q = Linear(channels, channels)
        self.to_k = Linear(channels, channels)
        self.to_v = Linear(channels, channels)
        self.to_out_0 = Linear(channels, channels)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = (m(h)[:, :, None, :] for m in (self.to_q, self.to_k,
                                                 self.to_v))
        out = attention_core(q, k, v, 1.0 / math.sqrt(C),
                             self.to_q.weight.dtype)[:, :, 0, :]
        out = self.to_out_0(out)
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class Encoder(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        ch = list(block_out_channels)
        self.n_blocks, self.layers_per_block = len(ch), layers_per_block
        self.conv_in = Conv2d(3, ch[0], 3, padding=1)
        cur = ch[0]
        for i, out_ch in enumerate(ch):
            for j in range(layers_per_block):
                self.add_module(f"down_blocks_{i}_resnets_{j}",
                                ResnetBlock2D(cur, out_ch, eps=1e-6))
                cur = out_ch
            if i != len(ch) - 1:
                self.add_module(f"down_blocks_{i}_downsamplers_0",
                                Downsample2D(cur, asymmetric_pad=True))
        self.mid_block_resnets_0 = ResnetBlock2D(cur, cur, eps=1e-6)
        self.mid_block_attentions_0 = VAEAttention(cur)
        self.mid_block_resnets_1 = ResnetBlock2D(cur, cur, eps=1e-6)
        self.conv_norm_out = GroupNorm(cur, 32, 1e-6)
        self.conv_out = Conv2d(cur, 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for i in range(self.n_blocks):
            for j in range(self.layers_per_block):
                h = getattr(self, f"down_blocks_{i}_resnets_{j}")(h)
            if i != self.n_blocks - 1:
                h = getattr(self, f"down_blocks_{i}_downsamplers_0")(h)
        h = self.mid_block_resnets_0(h)
        h = self.mid_block_attentions_0(h)
        h = self.mid_block_resnets_1(h)
        h = F.silu(self.conv_norm_out(h)).to(self.conv_out.weight.dtype)
        return self.conv_out(h)


class Decoder(nn.Module):
    """conv_in, the mid block (two resnets around the attention), up blocks
    of layers_per_block resnets each with an Upsample2D between them, then
    GroupNorm, SiLU and conv_out (vae.py:78-106): its layers only."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 3, latent_channels: int = 4):
        super().__init__()
        ch = list(block_out_channels)[::-1]          # (512, 512, 256, 128)
        self.n_blocks, self.layers_per_block = len(ch), layers_per_block
        self.conv_in = Conv2d(latent_channels, ch[0], 3, padding=1)
        self.mid_block_resnets_0 = ResnetBlock2D(ch[0], ch[0], eps=1e-6)
        self.mid_block_attentions_0 = VAEAttention(ch[0])
        self.mid_block_resnets_1 = ResnetBlock2D(ch[0], ch[0], eps=1e-6)
        cur = ch[0]
        for i, out_ch in enumerate(ch):
            for j in range(layers_per_block):
                self.add_module(f"up_blocks_{i}_resnets_{j}",
                                ResnetBlock2D(cur, out_ch, eps=1e-6))
                cur = out_ch
            if i != len(ch) - 1:
                self.add_module(f"up_blocks_{i}_upsamplers_0",
                                Upsample2D(cur))
        self.conv_norm_out = GroupNorm(cur, 32, 1e-6)
        self.conv_out = Conv2d(cur, 3, 3, padding=1)


class AutoencoderKL(nn.Module):
    """The SD VAE: encoder + quant_conv, post_quant_conv + decoder (whose
    up blocks take one resnet more than the encoder's down blocks)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4):
        super().__init__()
        # registered in data-flow order, encoder side first: a random init
        # (sds.init_sd_module) draws the encoder's weights first, so the
        # SDS path's weights do not depend on the decoder's
        self.encoder = Encoder(block_out_channels, layers_per_block,
                               latent_channels)
        self.quant_conv = Conv2d(2 * latent_channels, 2 * latent_channels, 1)
        self.post_quant_conv = Conv2d(latent_channels, latent_channels, 1)
        self.decoder = Decoder(block_out_channels, layers_per_block + 1,
                               latent_channels)

    def moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B,H,W,3] in [-1,1] -> (mean, logvar) [B,h,w,4] f32."""
        m = self.quant_conv(self.encoder(x.permute(0, 3, 1, 2)))
        mean, logvar = m.float().permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def encode(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Posterior sample mean + std * eps (nerf/sd.py:162); eps
        (optional) is a standard normal of the latent shape."""
        mean, logvar = self.moments(x)
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator,
                              device=mean.device)
        return mean + torch.exp(0.5 * logvar) * eps
