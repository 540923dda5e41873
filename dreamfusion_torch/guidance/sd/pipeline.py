"""Standalone Stable Diffusion txt2img pipeline and CLI (counterpart of
dreamfusion_tpu/guidance/sd/pipeline.py; reference nerf/sd.py:120-214).

prompt -> text embeddings -> denoising (PLMS, the full PNDM or DDIM) with
classifier-free guidance as one UNet call on 2B latents -> VAE decode ->
uint8 image. Latents keep the public NHWC layout [B, h/8, w/8, 4].

    python -m dreamfusion_torch.guidance.sd.pipeline "a photo of a corgi" \\
        --sd_weights random-full -H 512 -W 512 --steps 50 --sampler plms

SD weights are random (random-full: SD v1.5 widths in bf16; random-tiny /
random-nano: f32, images capped at 64 px), and the text embeddings are the
port's per-prompt stand-ins (sds.pseudo_text_embeds).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence, Union

import numpy as np
import torch

from dreamfusion_torch.device import resolve_device
from dreamfusion_torch.guidance.sd.scheduler import (DiffusionSchedule,
                                                     PNDMState, ddim_step,
                                                     ddim_timesteps,
                                                     make_schedule,
                                                     pndm_plms_step,
                                                     pndm_prk_step)
from dreamfusion_torch.guidance.sd.sds import build_sd_guidance
from dreamfusion_torch.guidance.sd.unet import UNet2DCondition
from dreamfusion_torch.guidance.sd.vae import AutoencoderKL

SAMPLERS = ("plms", "pndm", "ddim")
PRK_WARMUP = 3     # pseudo Runge-Kutta transfers before PLMS (sampler pndm)


@torch.inference_mode()
def produce_latents(unet: UNet2DCondition, sched: DiffusionSchedule,
                    text_z: torch.Tensor, *, height: int = 512,
                    width: int = 512, num_inference_steps: int = 50,
                    guidance_scale: float = 7.5,
                    latents: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    sampler: str = "plms") -> torch.Tensor:
    """text_z [B, 2, 77, D] (uncond, cond) -> latents [B, h/8, w/8, 4] f32
    (nerf/sd.py:120-143). latents (optional): the starting noise, else a
    standard normal from `generator` on text_z's device."""
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler {sampler!r}: choose from "
                         f"{', '.join(SAMPLERS)}")
    B, dev = text_z.shape[0], text_z.device
    if latents is None:
        latents = torch.randn(B, height // 8, width // 8, 4,
                              generator=generator, device=dev)
    ts = ddim_timesteps(sched.num_train_timesteps, num_inference_steps)
    ctx = torch.cat([text_z[:, 0], text_z[:, 1]])

    def eps_fn(x: torch.Tensor, t: int) -> torch.Tensor:
        eps = unet(torch.cat([x, x]),
                   torch.full((2 * B,), t, dtype=torch.long, device=dev), ctx)
        return eps[:B] + guidance_scale * (eps[B:] - eps[:B])

    state = PNDMState(ets=(), cur_sample=latents, counter=0)
    for i, t in enumerate(ts.tolist()):
        t_prev = int(ts[i + 1]) if i + 1 < len(ts) else -1
        if sampler == "pndm" and i < PRK_WARMUP:
            latents, state = pndm_prk_step(sched, eps_fn, latents, t, t_prev,
                                           state)
        elif sampler == "ddim":
            latents = ddim_step(sched, eps_fn(latents, t), t, t_prev, latents)
        else:
            latents, state = pndm_plms_step(sched, eps_fn(latents, t), t,
                                            t_prev, latents, state)
    return latents


@torch.inference_mode()
def decode_latents(vae: AutoencoderKL, latents: torch.Tensor) -> torch.Tensor:
    """latents [B, h, w, 4] -> images [B, 8h, 8w, 3] f32 in [0, 1]
    (nerf/sd.py:145-154)."""
    return torch.clamp(vae.decode(latents / vae.scaling_factor) / 2.0 + 0.5,
                       0.0, 1.0)


def prompt_to_img(prompts: Union[str, Sequence[str]],
                  negative_prompts: Union[str, Sequence[str]] = "", *,
                  sd_weights: Optional[str] = None, height: int = 512,
                  width: int = 512, num_inference_steps: int = 50,
                  guidance_scale: float = 7.5, seed: int = 0,
                  sampler: str = "plms",
                  latents: Optional[torch.Tensor] = None,
                  text_z: Optional[torch.Tensor] = None,
                  guidance=None, device=None) -> np.ndarray:
    """Prompts -> uint8 images [B, H, W, 3] (nerf/sd.py:166-187).

    The models are those of build_sd_guidance(sd_weights) (None =
    random-tiny), initialised from a generator seeded with 0, or those of
    a given `guidance`; the starting latents are drawn from a generator
    seeded with `seed`. latents and text_z (optional) replace the drawn
    noise and the stand-in embeddings."""
    if isinstance(prompts, str):
        prompts = [prompts]
    if isinstance(negative_prompts, str):
        negative_prompts = [negative_prompts] * len(prompts)
    device = resolve_device(device)
    if guidance is None:
        guidance = build_sd_guidance(
            sd_weights, guidance_scale=guidance_scale,
            dtype=torch.bfloat16, device=device,
            generator=torch.Generator(device=device).manual_seed(0))
    if guidance.modules["unet"].addition_time_embed_dim:
        raise NotImplementedError("txt2img with SDXL's text-time "
                                  "conditioning is not ported")
    if guidance.modules["latent_size"] < 64:     # the tiny models: 64 px
        height, width = min(height, 64), min(width, 64)
    if text_z is None:
        text_z = guidance.get_text_embeds(prompts, negative_prompts)
    lat = produce_latents(
        guidance.modules["unet"], make_schedule(device=device),
        text_z.to(device), height=height, width=width,
        num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale,
        latents=None if latents is None else latents.to(device),
        generator=torch.Generator(device=device).manual_seed(seed),
        sampler=sampler)
    imgs = decode_latents(guidance.modules["vae"], lat)
    return (imgs * 255).round().to(torch.uint8).cpu().numpy()


def main(argv=None) -> str:
    ap = argparse.ArgumentParser("sd txt2img")
    ap.add_argument("prompt", type=str)
    ap.add_argument("--negative", default="", type=str)
    ap.add_argument("-H", type=int, default=512)
    ap.add_argument("-W", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--sd_weights", type=str, default=None)
    ap.add_argument("--sampler", choices=SAMPLERS, default="plms")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    ap.add_argument("--out", type=str, default="txt2img.png")
    args = ap.parse_args(argv)
    imgs = prompt_to_img(args.prompt, args.negative,
                         sd_weights=args.sd_weights, height=args.H,
                         width=args.W, num_inference_steps=args.steps,
                         seed=args.seed, sampler=args.sampler,
                         device=args.device)
    from dreamfusion_torch.training.trainer import write_png

    write_png(args.out, imgs[0])
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
