"""Stable Diffusion guidance (UNet, VAE encoder, scheduler, SDS loss)."""
