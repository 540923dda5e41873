"""The runner of SDS mixes whose guidance is SDXL base 1.0: runners/sds.py's
set-up, closed loop of ``Trainer.advance`` and comparison, with the SD
modules, the text embeddings and the reference's step swapped for
SDXL's.

- The program's modules: ``UNet2DCondition`` built from the
  configuration's ``unet`` group, whose keys are diffusers'
  ``unet/config.json``'s (``attention_head_dim`` counts heads: the
  program's ``attention_heads``), and ``AutoencoderKL`` with the
  configuration's ``scale``; ``sd_guidance`` around them feeds the pooled
  embedding and the time ids of the 8 x latent_size image to both CFG
  halves.
- The text embeddings: stand-ins for the context [6, 2, 77, D]
  (inputs.text_embeddings), then the pooled embedding [6, 2, P], both
  standard normal from the run's text stream, handed to the Trainer as
  its dict ``{"context", "pooled"}``.
- The reference: dfref/sd/sdxl.py (``UNet2DConditionXL``, ``SDXLStep``),
  in float32 with TF32 off; the control as runners/sds.py's, SD in float8.

sds.Run's set-up and reference are reused as they are, with these three
names swapped while they run (``_as_sdxl``); its window, release and
readings are unchanged. ``trace`` counts SDXL's operations a step
(``sdxl_step_flops``)."""

from __future__ import annotations

import contextlib
import functools
import json
from typing import Dict

import torch

from benchkit import counts, inputs
from benchkit.trace import profiled
from runners import sds

UNIT = sds.UNIT


def program_unet_kwargs(unet: Dict) -> Dict:
    """The program's UNet2DCondition kwargs from config.json's keys."""
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in unet.items() if k != "n_params"}
    kw["attention_heads"] = kw.pop("attention_head_dim")
    return kw


def reference_unet_kwargs(unet: Dict) -> Dict:
    """dfref's UNet2DConditionXL kwargs from config.json's keys."""
    return {"in_channels": unet["in_channels"],
            "out_channels": unet["out_channels"],
            "block_out_channels": tuple(unet["block_out_channels"]),
            "layers_per_block": unet["layers_per_block"],
            "attention_heads": tuple(unet["attention_head_dim"]),
            "cross_attention_dim": unet["cross_attention_dim"],
            "attention_levels": tuple("CrossAttn" in b
                                      for b in unet["down_block_types"]),
            "transformer_layers_per_block":
                tuple(unet["transformer_layers_per_block"]),
            "addition_time_embed_dim": unet["addition_time_embed_dim"],
            "pooled_dim": pooled_dim(unet)}


def pooled_dim(unet: Dict) -> int:
    """The pooled text embedding's width: the text-time embedding's input
    less the six time ids' sinusoids."""
    return (unet["projection_class_embeddings_input_dim"]
            - 6 * unet["addition_time_embed_dim"])


def _sd_modules(pkg: str, sd: Dict, device):
    """The UNet and VAE of the program (``dreamfusion_torch.guidance.sd``)
    or of the reference (``dfref.sd``) at the configuration's widths."""
    vae_kw = counts.sd_vae_kwargs(sd["vae"])
    with torch.device(device):
        if pkg == "dfref.sd":
            from dfref.sd.sdxl import UNet2DConditionXL
            from dfref.sd.vae import AutoencoderKL

            return (UNet2DConditionXL(**reference_unet_kwargs(sd["unet"])),
                    AutoencoderKL(**vae_kw))
        from dreamfusion_torch.guidance.sd.unet import UNet2DCondition
        from dreamfusion_torch.guidance.sd.vae import AutoencoderKL

        return (UNet2DCondition(**program_unet_kwargs(sd["unet"])),
                AutoencoderKL(**vae_kw, scaling_factor=sd["scale"]))


@functools.lru_cache(maxsize=4)
def _step_flops(sd_json: str) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    sd = json.loads(sd_json)
    unet_kw = reference_unet_kwargs(sd["unet"])
    latent = sd["latent_size"]
    unet, vae = _sd_modules("dfref.sd", sd, "meta")
    unet.requires_grad_(False)
    vae.requires_grad_(False)
    with torch.device("meta"):
        x = torch.empty(2, latent, latent, unet_kw["in_channels"])
        ctx = torch.empty(2, 77, unet_kw["cross_attention_dim"])
        pooled = torch.empty(2, unet_kw["pooled_dim"])
        ids = torch.empty(2, 6)
        t = torch.zeros(2, dtype=torch.long)
        img = torch.empty(1, 8 * latent, 8 * latent, 3, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            unet(x, t, ctx, pooled, ids)
        mean, _ = vae.moments(img)
        mean.sum().backward()
    return float(fc.get_total_flops())


def sdxl_step_flops(sd: Dict) -> float:
    """An SDS step's SD operations, by torch.utils.flop_counter over the
    reference's modules on the ``meta`` device: the UNet's CFG forward
    (batch 2) and the VAE encoder's forward and input gradient at 8 x the
    latent size (matrix products and convolutions)."""
    return _step_flops(json.dumps(sd, sort_keys=True))


class Run(sds.Run):
    unit = UNIT

    def __init__(self, cell, seed: int, device="cuda"):
        with self._as_sdxl(cell):
            super().__init__(cell, seed, device)

    @contextlib.contextmanager
    def _as_sdxl(self, cell):
        """sds.Run's SD module factory, text stand-ins and reference step
        swapped for SDXL's while the block runs."""
        import dfref.steps
        from dfref.sd.sdxl import SDXLStep

        pdim = pooled_dim(cell.config["sd"]["unet"])
        plain_text = inputs.text_embeddings

        def text(n_dirs, dim, generator, device):
            context = plain_text(n_dirs, dim, generator, device)
            pooled = torch.randn(n_dirs, 2, pdim, generator=generator,
                                 device=device)
            return {"context": context, "pooled": pooled}

        def step(cfg, model, unet, vae, sched, text_z, latent_size,
                 fault=None):
            return SDXLStep(cfg, model, unet, vae, sched, text_z["context"],
                            text_z["pooled"], latent_size, fault=fault)

        saved = (sds._sd_modules, inputs.text_embeddings, dfref.steps.SDSStep)
        sds._sd_modules, inputs.text_embeddings = _sd_modules, text
        dfref.steps.SDSStep = step
        try:
            yield
        finally:
            (sds._sd_modules, inputs.text_embeddings,
             dfref.steps.SDSStep) = saved

    def trace(self):
        """The mix's trace_steps under the profiler -> (Summary, extra)."""
        out = {}

        def stretch():
            out["n"], out["losses"] = self.steps(
                n=self.cell.mix["trace_steps"])

        summary = profiled(stretch)
        sd = self.cell.config["sd"]
        return summary, {"units": out["n"], "losses": out["losses"],
                         "sd_step_flops": sdxl_step_flops(sd), "sd": sd}

    def reference(self, precision: str = "f32", fault=None):
        with self._as_sdxl(self.cell):
            return super().reference(precision, fault)


readings = sds.readings
leaf_gaps = sds.leaf_gaps
