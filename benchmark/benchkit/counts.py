"""Operations and bytes a piece of work needs, counted from the
configuration's shapes (and, where the work depends on the data, from the
step's inputs), never from what the program launched.

- ``sd_step_flops``: an SDS step's SD work, the UNet's CFG forward (batch
  2) plus the VAE encoder's forward and its input gradient at the image
  size, by torch.utils.flop_counter over the plain reference's modules on
  the ``meta`` device (matrix products and convolutions; the field's
  work, about 1%, and elementwise work are left out);
- ``attention_flops``: softmax(q k^T) v, 4 B H N^2 D;
- ``dvgo_step_work``: a DVGO pretraining step's least work."""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch


def attention_flops(B: int, H: int, N: int, D: int) -> float:
    """The two products q k^T and p v of one attention call."""
    return 4.0 * B * H * N * N * D


def attention_bytes(B: int, H: int, N: int, D: int, itemsize: int = 2) -> float:
    """q, k, v read once and o written once."""
    return 4.0 * B * H * N * D * itemsize


def sd_unet_kwargs(unet: Dict) -> Dict:
    return {"block_out_channels": tuple(unet["block_out_channels"]),
            "layers_per_block": unet["layers_per_block"],
            "attention_heads": unet["attention_head_dim"],
            "cross_attention_dim": unet["cross_attention_dim"],
            "in_channels": unet["in_channels"],
            "out_channels": unet["out_channels"]}


def sd_vae_kwargs(vae: Dict) -> Dict:
    return {"block_out_channels": tuple(vae["block_out_channels"]),
            "layers_per_block": vae["layers_per_block"],
            "latent_channels": vae["latent_channels"]}


@functools.lru_cache(maxsize=8)
def _sd_flops(unet_key: Tuple, vae_key: Tuple, latent: int,
              cfg_batch: int) -> Tuple[float, float, float]:
    from torch.utils.flop_counter import FlopCounterMode

    from dfref.sd.unet import UNet2DCondition
    from dfref.sd.vae import AutoencoderKL

    unet_kw, vae_kw = dict(unet_key), dict(vae_key)
    with torch.device("meta"):
        unet = UNet2DCondition(**unet_kw).requires_grad_(False)
        vae = AutoencoderKL(**vae_kw).requires_grad_(False)
        x = torch.empty(cfg_batch, latent, latent, unet_kw["in_channels"])
        t = torch.zeros(cfg_batch, dtype=torch.long)
        ctx = torch.empty(cfg_batch, 77, unet_kw["cross_attention_dim"])
        img = torch.empty(cfg_batch // 2, 8 * latent, 8 * latent, 3,
                          requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            unet(x, t, ctx)
    f_unet = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        mean, _ = vae.moments(img)
    f_enc = fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        mean, _ = vae.moments(img)
        mean.sum().backward()
    f_enc_grad = fc.get_total_flops()
    return float(f_unet), float(f_enc), float(f_enc_grad)


def sd_flops(sd: Dict, cfg_batch: int = 2) -> Tuple[float, float, float]:
    """(UNet CFG forward, VAE encoder forward, VAE encoder forward and
    input gradient) operations at the configuration's widths."""
    return _sd_flops(tuple(sd_unet_kwargs(sd["unet"]).items()),
                     tuple(sd_vae_kwargs(sd["vae"]).items()),
                     int(sd["latent_size"]), cfg_batch)


def sd_step_flops(sd: Dict) -> float:
    """An SDS step's SD operations: the UNet's CFG forward, the VAE
    encoder's forward and its input gradient."""
    f_unet, _, f_enc_grad = sd_flops(sd)
    return f_unet + f_enc_grad


def dvgo_step_work(n_rays: int, n_inside: int, n_alive: int,
                   n_voxels: int, k0_dim: int, rgb_in: int, width: int,
                   depth: int, rgb_out: int = 3) -> Tuple[float, float]:
    """(operations, bytes) of one DVGO fine step.

    Operations: the rgbnet's forward on the live samples (a Linear of
    rgb_in -> width, depth - 2 of width -> width, width -> rgb_out) and
    its backward (the weights' and the inputs' gradients, twice the
    forward), and the trilinear gathers' blends and their gradients (8
    corners, a multiply-add each: the density at every sample inside the
    box, k0's channels at the live ones). Bytes: every input read once and
    every output written once: the grids, the rgbnet and Adam's two moments
    read and written, the rays (origin, direction, view direction and
    target: 12 floats) read."""
    mlp = rgb_in * width + (depth - 2) * width * width + width * rgb_out
    flops = 3 * 2.0 * mlp * n_alive
    flops += 3 * 2.0 * 8 * (n_inside + n_alive * k0_dim)
    n_params = n_voxels * (1 + k0_dim) + mlp + width * (depth - 1) + rgb_out
    nbytes = 2 * 3 * 4.0 * n_params + 12 * 4.0 * n_rays
    return flops, nbytes
