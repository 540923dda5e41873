"""AutoencoderKL, the SD VAE (counterpart of
dreamfusion_tpu/guidance/sd/vae.py).

The encoder runs during SDS (with gradients, nerf/sd.py:156-164); the
decoder serves txt2img (guidance/sd/pipeline.py). NCHW inside, [B,H,W,C]
at ``moments`` / ``encode`` / ``decode``. The mid blocks' single-head
attention goes through ``layers.attention_core``, so at 64x64 latents in
bf16 it takes the flash kernels (N = 4,096 tokens, one head of 512).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dreamfusion_torch.guidance.sd.layers import GroupNorm, attention_core
from dreamfusion_torch.guidance.sd.unet import (Conv2d, Downsample2D, Linear,
                                                ResnetBlock2D, Upsample2D)


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
    GroupNorm, SiLU and conv_out; the output is f32 (vae.py:78-106)."""

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

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_block_resnets_0(h)
        h = self.mid_block_attentions_0(h)
        h = self.mid_block_resnets_1(h)
        for i in range(self.n_blocks):
            for j in range(self.layers_per_block):
                h = getattr(self, f"up_blocks_{i}_resnets_{j}")(h)
            if i != self.n_blocks - 1:
                h = getattr(self, f"up_blocks_{i}_upsamplers_0")(h)
        h = F.silu(self.conv_norm_out(h)).to(self.conv_out.weight.dtype)
        return self.conv_out(h).float()


class AutoencoderKL(nn.Module):
    """The SD VAE: encoder + quant_conv, post_quant_conv + decoder (whose
    up blocks take one resnet more than the encoder's down blocks).
    ``scaling_factor`` (vae/config.json's) scales the latents the UNet
    sees: 0.18215 for SD v1.x, 0.13025 for SDXL."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 scaling_factor: float = 0.18215):
        super().__init__()
        self.scaling_factor = scaling_factor
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

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents [B,h,w,4] (unscaled) -> images [B,8h,8w,3] f32 in about
        [-1, 1]."""
        x = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        return x.permute(0, 2, 3, 1)


def sd15_vae() -> AutoencoderKL:
    return AutoencoderKL()


SDXL_SCALING_FACTOR = 0.13025     # SDXL base 1.0's vae/config.json


def sdxl_vae() -> AutoencoderKL:
    """SDXL base 1.0's VAE: SD v1.5's widths, its own latent scale."""
    return AutoencoderKL(scaling_factor=SDXL_SCALING_FACTOR)


def tiny_vae(scaling_factor: float = 0.18215) -> AutoencoderKL:
    return AutoencoderKL(block_out_channels=(32, 32, 64, 64),
                         layers_per_block=1, scaling_factor=scaling_factor)


def nano_vae() -> AutoencoderKL:
    return AutoencoderKL(block_out_channels=(32, 32), layers_per_block=1)
