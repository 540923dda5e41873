"""Diffusion schedule constants (counterpart of
dreamfusion_tpu/guidance/sd/scheduler.py: make_schedule, add_noise).

scaled_linear betas as in the reference's PNDMScheduler(0.00085, 0.012,
T=1000) (nerf/sd.py:49-50); SDS uses only alphas_cumprod and add_noise.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dreamfusion_torch.device import resolve_device


class DiffusionSchedule(NamedTuple):
    betas: torch.Tensor           # [T]
    alphas_cumprod: torch.Tensor  # [T]
    num_train_timesteps: int


def make_schedule(num_train_timesteps: int = 1000, beta_start: float = 0.00085,
                  beta_end: float = 0.012,
                  device: Optional[torch.device] = None) -> DiffusionSchedule:
    """betas = linspace(sqrt(b0), sqrt(b1), T)**2 (computed in float64)."""
    device = resolve_device(device)
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                        num_train_timesteps, dtype=np.float64) ** 2
    acp = np.cumprod(1.0 - betas)
    return DiffusionSchedule(
        betas=torch.tensor(betas, dtype=torch.float32, device=device),
        alphas_cumprod=torch.tensor(acp, dtype=torch.float32, device=device),
        num_train_timesteps=num_train_timesteps)


def add_noise(sched: DiffusionSchedule, latents: torch.Tensor,
              noise: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """x_t = sqrt(acp_t) x_0 + sqrt(1 - acp_t) eps; t [B] int."""
    acp = sched.alphas_cumprod[t]
    shape = (-1,) + (1,) * (latents.ndim - 1)
    return (torch.sqrt(acp).reshape(shape) * latents
            + torch.sqrt(1.0 - acp).reshape(shape) * noise)
