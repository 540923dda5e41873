"""Score Distillation Sampling as one scalar loss (counterpart of
dreamfusion_tpu/guidance/sd/sds.py), with SD v1.5 or SDXL base 1.0.

    loss_sds = sum( detach(w * (eps_hat - eps)) * latents )

so d(loss)/d(latents) = w (eps_hat - eps), the reference's
latents.backward(gradient=...) (nerf/sd.py:74-118). Per step: bilinear
resize to 8x the latent size (512^2 for SD v1.5, 1024^2 for SDXL) -> VAE
encode (with grad) * the VAE's scaling_factor (0.18215 / 0.13025) -> t ~
U{20..980} -> add noise -> UNet with CFG (no grad) -> w = 1 -
alphas_cumprod[t]. SDXL's text_z is a dict: the context [n, 2, 77, 2048]
and the pooled embedding [n, 2, 1280] (uncond, cond), indexed together;
both CFG halves get the pooled embedding of their own half and the time
ids (H, W, 0, 0, H, W) of the encoded image. The encode and the CFG
forward run under the spans step/guidance/vae_encode and
step/guidance/unet (dreamfusion_torch.trace).

``build_sd_guidance`` builds random models or loads a local diffusers SD
v1.5 directory with its text encoder (``build_guidance`` finds a mounted
one through guidance/sd/probe.py).
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Dict, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from dreamfusion_torch import trace
from dreamfusion_torch.device import resolve_device
from dreamfusion_torch.guidance import Guidance
from dreamfusion_torch.guidance.sd.layers import GroupNorm
from dreamfusion_torch.guidance.sd.scheduler import (DiffusionSchedule,
                                                     add_noise, make_schedule)
from dreamfusion_torch.guidance.sd.unet import (LayerNorm, UNet2DCondition,
                                                nano_unet, sd15_unet,
                                                sdxl_unet, tiny_unet,
                                                tiny_xl_unet)
from dreamfusion_torch.guidance.sd.vae import (SDXL_SCALING_FACTOR,
                                               AutoencoderKL, nano_vae,
                                               sd15_vae, sdxl_vae, tiny_vae)
from dreamfusion_torch.models.networks import lecun_normal_

TextZ = Union[torch.Tensor, Dict[str, torch.Tensor]]


def sdxl_time_ids(size: int, device=None) -> torch.Tensor:
    """SDXL's six time ids of a size^2 image: original size, crop corner
    (0, 0), target size."""
    return torch.tensor([size, size, 0, 0, size, size], dtype=torch.float32,
                        device=device)


def sds_loss(unet: UNet2DCondition, vae: AutoencoderKL,
             sched: DiffusionSchedule, text_z: TextZ,
             pred_rgb: torch.Tensor, *, guidance_scale: float = 100.0,
             min_step: int = 20, max_step: int = 980, latent_size: int = 64,
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, torch.Tensor]] = None,
             time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """text_z [B,2,77,D] (uncond, cond), or SDXL's dict of it ("context")
    and the pooled embedding [B,2,P] ("pooled"); pred_rgb [B,H,W,3] in
    [0,1]. draws (optional): vae_eps (posterior noise, latent shape), t [B]
    int in [min_step, max_step], noise (latent shape). time_ids (SDXL, [6]):
    by default sdxl_time_ids of the encoded image."""
    draws = draws or {}
    B = pred_rgb.shape[0]
    dev = pred_rgb.device
    size = latent_size * 8
    context, pooled = ((text_z["context"], text_z["pooled"])
                       if isinstance(text_z, dict) else (text_z, None))
    with trace.span("step/guidance/vae_encode"):
        img = F.interpolate(pred_rgb.permute(0, 3, 1, 2), size=(size, size),
                            mode="bilinear", align_corners=False)
        latents = vae.encode(2.0 * img.permute(0, 2, 3, 1) - 1.0,
                             eps=draws.get("vae_eps"),
                             generator=generator) * vae.scaling_factor
    t = draws.get("t")
    if t is None:
        t = torch.randint(min_step, max_step + 1, (B,), generator=generator,
                          device=dev)
    noise = draws.get("noise")
    if noise is None:
        noise = torch.randn(latents.shape, generator=generator, device=dev)
    t = t.to(dev).long()
    with torch.no_grad(), trace.span("step/guidance/unet"):
        latents_noisy = add_noise(sched, latents.detach(), noise, t)
        cond = {}
        if pooled is not None:
            if time_ids is None:
                time_ids = sdxl_time_ids(size, dev)
            cond = {"text_embeds": torch.cat([pooled[:, 0], pooled[:, 1]]),
                    "time_ids": time_ids.expand(2 * B, -1)}
        eps = unet(torch.cat([latents_noisy, latents_noisy]),
                   torch.cat([t, t]),
                   torch.cat([context[:, 0], context[:, 1]]), **cond)
        eps_uncond, eps_text = eps[:B], eps[B:]
        eps_hat = eps_uncond + guidance_scale * (eps_text - eps_uncond)
        w = (1.0 - sched.alphas_cumprod[t]).reshape(B, 1, 1, 1)
        grad = w * (eps_hat - noise)
    return (grad * latents).sum()


def init_sd_module(module: nn.Module,
                   generator: Optional[torch.Generator] = None) -> nn.Module:
    """flax's default init for a randomly initialised SD model: lecun-normal
    kernels, zero biases, unit/zero norm parameters."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            lecun_normal_(m.weight, fan_in, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


def freeze(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store the frozen weights in the compute dtype (flax casts f32 params
    to it at every call; storing them cast gives the same numbers), keep
    the norm parameters f32, and turn off parameter gradients."""
    module.to(dtype)
    for m in module.modules():
        if isinstance(m, (GroupNorm, LayerNorm)):
            m.float()
    module.requires_grad_(False)
    return module.eval()


def pseudo_text_embeds(prompts, text_dim: int, device: torch.device,
                       pooled_dim: int = 0) -> TextZ:
    """Deterministic per-prompt stand-in embeddings for random-weight
    models, seeded by the prompt's md5 (as the JAX package seeds them;
    threefry and Philox give different numbers for the same seed):
    [n, 77, text_dim]; with pooled_dim (SDXL), {"context": that, "pooled":
    [n, pooled_dim] drawn next from each prompt's generator}."""
    outs, pooled = [], []
    for p in prompts:
        seed = int(hashlib.md5(p.encode()).hexdigest()[:8], 16)
        g = torch.Generator().manual_seed(seed)
        outs.append(torch.randn(77, text_dim, generator=g))
        if pooled_dim:
            pooled.append(torch.randn(pooled_dim, generator=g))
    context = torch.stack(outs).to(device)
    if not pooled_dim:
        return context
    return {"context": context, "pooled": torch.stack(pooled).to(device)}


def build_sd_guidance(weights: Optional[str] = None,
                      guidance_scale: float = 100.0,
                      dtype: torch.dtype = torch.float32,
                      device: Optional[torch.device] = None,
                      generator: Optional[torch.Generator] = None) -> Guidance:
    """SD guidance: 'random-full' (SD v1.5 widths, random, in `dtype`),
    'random-xl' (SDXL base 1.0's widths, random, in `dtype`, 1024 px
    images), 'random-tiny' / None, 'random-nano' or 'random-xl-tiny'
    (random, f32, 64 px images), or a local diffusers SD v1.5 directory (its
    weights in `dtype`, its CLIP text encoder and tokenizer;
    guidance/sd/convert.load_sd_dir). Any other name raises: a hub name
    would need the network."""
    device = resolve_device(device)
    text_encode = None
    if weights == "random-nano":
        unet, vae, latent_size, compute = nano_unet(), nano_vae(), 8, torch.float32
    elif weights in (None, "random-tiny"):
        unet, vae, latent_size, compute = tiny_unet(), tiny_vae(), 8, torch.float32
    elif weights == "random-xl-tiny":
        unet, vae, latent_size, compute = (
            tiny_xl_unet(), tiny_vae(SDXL_SCALING_FACTOR), 8, torch.float32)
    elif weights == "random-full":
        unet, vae, latent_size, compute = sd15_unet(), sd15_vae(), 64, dtype
    elif weights == "random-xl":
        unet, vae, latent_size, compute = sdxl_unet(), sdxl_vae(), 128, dtype
    elif os.path.isdir(weights):
        from dreamfusion_torch.guidance.sd.convert import (check_sd_dir,
                                                           load_sd_dir)

        check_sd_dir(weights)          # before building the SD v1.5 modules
        unet, vae, _, text_encode = load_sd_dir(
            weights, sd15_unet().to(device), sd15_vae().to(device))
        return sd_guidance(freeze(unet, dtype), freeze(vae, dtype), 64,
                           guidance_scale, generator=generator,
                           text_encode=text_encode)
    else:
        raise NotImplementedError(
            f"SD weights {weights!r}: not random-full / random-xl / "
            "random-tiny / random-nano / random-xl-tiny nor a local "
            "diffusers SD directory (a hub name would need the network)")
    unet = freeze(init_sd_module(unet.to(device), generator), compute)
    vae = freeze(init_sd_module(vae.to(device), generator), compute)
    return sd_guidance(unet, vae, latent_size, guidance_scale,
                       generator=generator)


def sd_guidance(unet: UNet2DCondition, vae: AutoencoderKL, latent_size: int,
                guidance_scale: float = 100.0,
                generator: Optional[torch.Generator] = None,
                text_encode: Optional[Callable] = None) -> Guidance:
    """Guidance around frozen SD modules (on the modules' device).
    text_encode (optional): prompts -> [n, 77, D], a loaded text encoder;
    without one, pseudo_text_embeds stands in (random-weight models; for
    a UNet with the text-time embedding (SDXL) the pooled embedding too)."""
    device = unet.conv_in.weight.device
    text_dim = unet.cross_attention_dim
    sched = make_schedule(device=device)
    pooled_dim, time_ids = 0, None
    if unet.addition_time_embed_dim:
        if text_encode is not None:
            raise NotImplementedError("SDXL's two text encoders are not "
                                      "ported")
        pooled_dim = (unet.add_embedding.linear_1.in_features
                      - 6 * unet.addition_time_embed_dim)
        time_ids = sdxl_time_ids(8 * latent_size, device)

    def embed(prompts):
        if text_encode is not None:
            return text_encode(list(prompts)).float()
        return pseudo_text_embeds(list(prompts), text_dim, device, pooled_dim)

    def get_text_embeds(prompts, negatives):
        """[n] prompts -> [n, 2, 77, D] (uncond, cond); SDXL: a dict of it
        ("context") and the pooled [n, 2, P] ("pooled")."""
        neg, pos = embed(negatives), embed(prompts)
        if isinstance(pos, dict):
            return {k: torch.stack([neg[k], pos[k]], dim=1) for k in pos}
        return torch.stack([neg, pos], dim=1)

    def loss(text_z, pred_rgb, draws=None, gen=None):
        return sds_loss(unet, vae, sched, text_z, pred_rgb,
                        guidance_scale=guidance_scale,
                        latent_size=latent_size, draws=draws,
                        generator=gen if gen is not None else generator,
                        time_ids=time_ids)

    return Guidance(name="stable-diffusion",
                    modules={"unet": unet, "vae": vae,
                             "latent_size": latent_size,
                             "text_encode": text_encode},
                    get_text_embeds=get_text_embeds, loss=loss)
