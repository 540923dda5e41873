# Plain PyTorch for the benchmark's reference and the CPU tests, after the
# program's dreamfusion_torch/guidance/sd/unet.py and sds.py; it imports
# nothing of the program.
"""SDXL base 1.0 as SDS guidance, in plain float32 PyTorch on the blocks
of dfref/sd/unet.py.

Source: https://huggingface.co/stabilityai/stable-diffusion-xl-base-1.0,
``unet/config.json`` and ``vae/config.json`` (Podell et al.,
arXiv:2307.01952). ``UNet2DConditionXL``'s forward:

- temb = TimestepEmbedding(320, 1280)(sinusoid(t, 320));
- aug = TimestepEmbedding(2816, 1280)(cat[pooled, sinusoid(time_ids,
  256).flatten]); emb = temb + aug;
- levels of 320, 640 and 1280 channels, two resnets a down block, three
  an up block; level 0 has no attention; at levels 1 and 2 each resnet is
  followed by a stack: GroupNorm(32, eps 1e-6), a Linear in, 2 (level 1)
  or 10 (level 2 and the mid block) BasicTransformerBlocks of 64-wide
  heads (10 / 20 of them) over a 2048-wide context, a Linear out, plus
  the input; skips, downsamplers and upsamplers as in SD v1.5.

It departs from diffusers where the program does, on purpose: LayerNorm
epsilon 1e-6 (diffusers 1e-5) and the tanh GELU in GEGLU (diffusers: the
exact one). Both sides build their modules in the same order under the
same names, so a state dict, or a seeded fill in module order, moves
between them unchanged.

``sds_loss``: SDS as one scalar (the program's guidance/sd/sds.py) with
the pooled embedding and the time ids fed to both CFG halves and the
latents scaled by 0.13025. ``SDXLStep``: dfref.steps.SDSStep with it.
The benchmark computes it as its other references, with TF32 off
(runners/sds.py's ``reference``, which runners/sdxl.py reuses)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from dfref import cameras
from dfref.models.networks import make_field_fns
from dfref.ops.marching import render_grid
from dfref.sd.layers import GroupNorm
from dfref.sd.scheduler import add_noise
from dfref.sd.unet import (BasicTransformerBlock, Conv2d, Downsample2D,
                           Linear, ResnetBlock2D, TimestepEmbedding,
                           Upsample2D, timestep_embedding)
from dfref.steps import SDSStep, leave_out_half, shading_schedule

LATENT_SCALE = 0.13025          # vae/config.json's scaling_factor


class TransformerStack(nn.Module):
    """GroupNorm, Linear in, `depth` BasicTransformerBlocks, Linear out,
    plus the input (diffusers' Transformer2DModel with
    use_linear_projection)."""

    def __init__(self, channels: int, context_dim: int, heads: int,
                 depth: int):
        super().__init__()
        self.depth = depth
        self.norm = GroupNorm(channels, 32, 1e-6)
        self.proj_in = Linear(channels, channels)
        for d in range(depth):
            self.add_module(
                f"transformer_blocks_{d}",
                BasicTransformerBlock(channels, context_dim, heads))
        self.proj_out = Linear(channels, channels)

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        h = self.proj_in(h)
        for d in range(self.depth):
            h = getattr(self, f"transformer_blocks_{d}")(h, context)
        h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        return h + x


class UNet2DConditionXL(nn.Module):
    """forward(latents [B,H,W,4], t [B], context [B,77,D], text_embeds
    [B,P], time_ids [B,6]) -> eps [B,H,W,4] f32. The defaults are SDXL base
    1.0's; attention_levels says which levels attend (up blocks mirror
    them, the mid block always does)."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 block_out_channels: Sequence[int] = (320, 640, 1280),
                 layers_per_block: int = 2,
                 attention_heads: Sequence[int] = (5, 10, 20),
                 cross_attention_dim: int = 2048,
                 attention_levels: Sequence[bool] = (False, True, True),
                 transformer_layers_per_block: Sequence[int] = (1, 2, 10),
                 addition_time_embed_dim: int = 256, pooled_dim: int = 1280):
        super().__init__()
        ch = list(block_out_channels)
        n = len(ch)
        self.block_out_channels, self.layers_per_block = ch, layers_per_block
        self.attention_levels = list(attention_levels)
        self.addition_time_embed_dim = addition_time_embed_dim
        heads, depth = attention_heads, transformer_layers_per_block
        ctx = cross_attention_dim
        temb_dim = ch[0] * 4
        self.time_embedding = TimestepEmbedding(ch[0], temb_dim)
        self.add_embedding = TimestepEmbedding(
            pooled_dim + 6 * addition_time_embed_dim, temb_dim)
        self.conv_in = Conv2d(in_channels, ch[0], 3, padding=1)

        skip_ch = [ch[0]]
        cur = ch[0]
        for i in range(n):
            for j in range(layers_per_block):
                self.add_module(f"down_blocks_{i}_resnets_{j}",
                                ResnetBlock2D(cur, ch[i], temb_dim))
                cur = ch[i]
                if attention_levels[i]:
                    self.add_module(f"down_blocks_{i}_attentions_{j}",
                                    TransformerStack(cur, ctx, heads[i],
                                                     depth[i]))
                skip_ch.append(cur)
            if i != n - 1:
                self.add_module(f"down_blocks_{i}_downsamplers_0",
                                Downsample2D(cur))
                skip_ch.append(cur)

        self.mid_block_resnets_0 = ResnetBlock2D(cur, ch[-1], temb_dim)
        self.mid_block_attentions_0 = TransformerStack(ch[-1], ctx, heads[-1],
                                                       depth[-1])
        self.mid_block_resnets_1 = ResnetBlock2D(ch[-1], ch[-1], temb_dim)
        cur = ch[-1]

        for i in range(n):
            level = n - 1 - i
            for j in range(layers_per_block + 1):
                self.add_module(f"up_blocks_{i}_resnets_{j}",
                                ResnetBlock2D(cur + skip_ch.pop(), ch[level],
                                              temb_dim))
                cur = ch[level]
                if attention_levels[level]:
                    self.add_module(f"up_blocks_{i}_attentions_{j}",
                                    TransformerStack(cur, ctx, heads[level],
                                                     depth[level]))
            if i != n - 1:
                self.add_module(f"up_blocks_{i}_upsamplers_0", Upsample2D(cur))

        self.conv_norm_out = GroupNorm(cur, 32, 1e-5)
        self.conv_out = Conv2d(cur, out_channels, 3, padding=1)

    def forward(self, sample, timesteps, context, text_embeds, time_ids):
        ch, n = self.block_out_channels, len(self.block_out_channels)
        dtype = self.conv_in.weight.dtype
        B = sample.shape[0]
        ids = timestep_embedding(time_ids.reshape(-1),
                                 self.addition_time_embed_dim).reshape(B, -1)
        temb = (self.time_embedding(timestep_embedding(timesteps, ch[0]))
                + self.add_embedding(torch.cat([text_embeds.float(), ids],
                                               -1))).to(dtype)
        context = context.to(dtype)
        h = self.conv_in(sample.permute(0, 3, 1, 2))
        skips = [h]
        for i in range(n):
            for j in range(self.layers_per_block):
                h = getattr(self, f"down_blocks_{i}_resnets_{j}")(h, temb)
                if self.attention_levels[i]:
                    h = getattr(self, f"down_blocks_{i}_attentions_{j}")(
                        h, context)
                skips.append(h)
            if i != n - 1:
                h = getattr(self, f"down_blocks_{i}_downsamplers_0")(h)
                skips.append(h)
        h = self.mid_block_resnets_0(h, temb)
        h = self.mid_block_attentions_0(h, context)
        h = self.mid_block_resnets_1(h, temb)
        for i in range(n):
            for j in range(self.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_blocks_{i}_resnets_{j}")(h, temb)
                if self.attention_levels[n - 1 - i]:
                    h = getattr(self, f"up_blocks_{i}_attentions_{j}")(
                        h, context)
            if i != n - 1:
                h = getattr(self, f"up_blocks_{i}_upsamplers_0")(h)
        h = self.conv_out(F.silu(self.conv_norm_out(h)).to(dtype))
        return h.float().permute(0, 2, 3, 1)


def sdxl_time_ids(size: int, B: int, device=None) -> torch.Tensor:
    """[B, 6]: the original size, the crop corner (0, 0) and the target
    size of a size^2 image."""
    return torch.tensor([[size, size, 0, 0, size, size]] * B,
                        dtype=torch.float32, device=device)


def sds_loss(unet, vae, sched, context, pooled, pred_rgb, draws, *,
             guidance_scale: float, latent_size: int = 128,
             scaling_factor: float = LATENT_SCALE,
             scale: Optional[list] = None) -> torch.Tensor:
    """sum(detach(w (eps_hat - eps)) * latents): context [B, 2, 77, D] and
    pooled [B, 2, P] (uncond, cond), pred_rgb [B, H, W, 3]; draws vae_eps,
    t, noise. Both CFG halves get the time ids of the 8 x latent_size
    image. With `scale` (a list), appends ||w (eps_hat - eps)||
    ||latents||, the bound of the sum's magnitude by Cauchy-Schwarz."""
    B = pred_rgb.shape[0]
    size = latent_size * 8
    img = F.interpolate(pred_rgb.permute(0, 3, 1, 2), size=(size, size),
                        mode="bilinear", align_corners=False)
    latents = vae.encode(2.0 * img.permute(0, 2, 3, 1) - 1.0,
                         eps=draws["vae_eps"]) * scaling_factor
    t = draws["t"].long()
    noise = draws["noise"]
    with torch.no_grad():
        noisy = add_noise(sched, latents.detach(), noise, t)
        eps = unet(torch.cat([noisy, noisy]), torch.cat([t, t]),
                   torch.cat([context[:, 0], context[:, 1]]),
                   torch.cat([pooled[:, 0], pooled[:, 1]]),
                   sdxl_time_ids(size, 2 * B, noisy.device))
        eps_uncond, eps_text = eps[:B], eps[B:]
        eps_hat = eps_uncond + guidance_scale * (eps_text - eps_uncond)
        w = (1.0 - sched.alphas_cumprod[t]).reshape(B, 1, 1, 1)
        grad = w * (eps_hat - noise)
        if scale is not None:
            scale.append(float(torch.linalg.vector_norm(grad)
                               * torch.linalg.vector_norm(latents)))
    return (grad * latents).sum()


class SDXLStep(SDSStep):
    """dfref.steps.SDSStep with SDXL's guidance: text_z is the context
    [n, 2, 77, D] and `pooled` [n, 2, P], indexed together by the view's
    direction."""

    def __init__(self, cfg, model, unet, vae, sched, text_z, pooled,
                 latent_size: int = 128, fault: Optional[str] = None):
        super().__init__(cfg, model, unet, vae, sched, text_z, latent_size,
                         fault)
        self.pooled = pooled

    def loss(self, step: int, grid_state, draws, K: int) -> torch.Tensor:
        cfg, model = self.cfg, self.model
        batch = cameras.sample_train_batch(cfg, draws=draws)
        B, N = cfg.batch_size, cfg.h * cfg.w
        code, ratio = shading_schedule(step, cfg.albedo_iters,
                                       float(draws["shade_u"]))
        out = render_grid(make_field_fns(model), grid_state,
                          batch["rays_o"].reshape(B * N, 3),
                          batch["rays_d"].reshape(B * N, 3),
                          max_steps=cfg.max_steps, K=K, dt_gamma=0.0,
                          bound=cfg.bound, min_near=cfg.min_near,
                          bg_radius=cfg.bg_radius, ambient_ratio=ratio,
                          shading_code=code, bg_color=draws["bg"],
                          perturb=True,
                          compute_normal_losses=cfg.lambda_orient > 0,
                          light_n=draws["light_n"],
                          perturb_u=draws["perturb_u"])
        image, ws = out["image"], out["weights_sum"]
        if self.fault == "half_batch":     # a planted fault (calibration)
            image, ws = leave_out_half(image, ws)
            ws = ws[:ws.shape[0] // 2]
        pred_ws = ws.reshape(B, -1)
        idx = (batch["dir"] if cfg.dir_text
               else torch.zeros(B, dtype=torch.long, device=image.device))
        scale: list = []
        loss = sds_loss(self.unet, self.vae, self.sched, self.text_z[idx],
                        self.pooled[idx], image.reshape(B, cfg.h, cfg.w, 3),
                        draws, guidance_scale=cfg.guidance_scale,
                        latent_size=self.latent_size, scale=scale)
        if cfg.lambda_opacity != 0:
            loss = loss + cfg.lambda_opacity * (pred_ws ** 2).mean()
        if cfg.lambda_entropy > 0:
            a = torch.clamp(pred_ws, 1e-5, 1 - 1e-5)
            loss = loss + cfg.lambda_entropy * (
                -a * torch.log2(a) - (1 - a) * torch.log2(1 - a)).mean()
        if cfg.lambda_orient > 0 and "loss_orient" in out:
            loss = loss + cfg.lambda_orient * out["loss_orient"]
        self.loss_scale = scale[0] + abs(float(loss.detach()))
        return loss
