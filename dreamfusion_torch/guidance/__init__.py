"""Guidance models driving the NeRF appearance (counterpart of
dreamfusion_tpu/guidance/__init__.py).

  guidance.get_text_embeds(prompts, negatives) -> text_z   (once, host side)
  guidance.loss(text_z, pred_rgb [B,H,W,3], draws=None) -> scalar

The SDS gradient is expressed as one differentiable scalar (guidance/sd/sds.py).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from dreamfusion_torch.device import resolve_device


class Guidance(NamedTuple):
    name: str
    modules: Any                 # frozen torch modules (or {})
    get_text_embeds: Callable    # (prompts, negatives) -> text_z
    loss: Callable               # (text_z, pred_rgb, draws=None, gen=None) -> scalar
    encode_images: Any = None    # optional: ([B,H,W,3]) -> features
                                 # (the CLIP-R-precision metric reads it)


def none_guidance(device: Optional[torch.device] = None) -> Guidance:
    """No guidance: regularizers only."""
    device = resolve_device(device)
    return Guidance(
        name="none", modules={},
        get_text_embeds=lambda prompts, negatives: torch.zeros(
            len(prompts), 1, device=device),
        loss=lambda text_z, pred_rgb, draws=None, gen=None: torch.zeros(
            (), device=device))


def build_guidance(cfg, device: torch.device,
                   generator: Optional[torch.Generator] = None) -> Guidance:
    """Dispatch like main.py:134-141 and the JAX package's build_guidance:
    stable-diffusion, CLIP or none. For sd_weights None or random-full the
    probe (guidance/sd/probe.py) looks for a mounted SD directory first and
    loads it when found; otherwise None builds random-tiny and random-full
    the SD-v1.5-sized random models. random-xl builds SDXL base 1.0 at its
    published widths (random weights, stand-in text embeddings)."""
    if cfg.guidance == "none" or cfg.text is None:
        return none_guidance(device)
    if cfg.guidance == "stable-diffusion":
        from dreamfusion_torch.guidance.sd.sds import build_sd_guidance

        sd_w = cfg.sd_weights
        if sd_w in (None, "random-full"):
            from dreamfusion_torch.guidance.sd.probe import find_sd_weights

            sd_w = find_sd_weights() or sd_w
        return build_sd_guidance(
            sd_w, guidance_scale=cfg.guidance_scale,
            dtype=torch.bfloat16 if cfg.fp16 else torch.float32,
            device=device, generator=generator)
    if cfg.guidance == "clip":
        from dreamfusion_torch.guidance.clip import build_clip_guidance

        return build_clip_guidance(cfg.clip_weights, device=device,
                                   generator=generator)
    raise NotImplementedError(f"guidance {cfg.guidance!r} is not ported yet")
