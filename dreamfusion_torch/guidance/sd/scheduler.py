"""Diffusion schedule constants and sampling steps (counterpart of
dreamfusion_tpu/guidance/sd/scheduler.py).

scaled_linear betas as in the reference's PNDMScheduler(0.00085, 0.012,
T=1000) (nerf/sd.py:49-50); SDS uses only alphas_cumprod and add_noise.
txt2img (pipeline.py) steps with DDIM, PLMS or the full PNDM (three
pseudo Runge-Kutta transfers, then PLMS). A step's timesteps are host
integers; t_prev = -1 marks the last step (alphas_cumprod taken as 1).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

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


def ddim_timesteps(num_train_timesteps: int,
                   num_inference_steps: int) -> np.ndarray:
    """Evenly spaced descending timesteps, 0 last."""
    step = num_train_timesteps // num_inference_steps
    return (np.arange(0, num_inference_steps) * step).round()[::-1].astype(
        np.int64)


def _acp(sched: DiffusionSchedule, t: int, t_prev: int):
    acp_t = sched.alphas_cumprod[t]
    acp_prev = (sched.alphas_cumprod[t_prev] if t_prev >= 0
                else torch.ones_like(acp_t))
    return acp_t, acp_prev


def ddim_step(sched: DiffusionSchedule, eps: torch.Tensor, t: int,
              t_prev: int, sample: torch.Tensor) -> torch.Tensor:
    """Deterministic DDIM update (eta = 0) x_t -> x_{t_prev}."""
    acp_t, acp_prev = _acp(sched, t, t_prev)
    x0 = (sample - torch.sqrt(1 - acp_t) * eps) / torch.sqrt(acp_t)
    return torch.sqrt(acp_prev) * x0 + torch.sqrt(1 - acp_prev) * eps


class PNDMState(NamedTuple):
    ets: Tuple[torch.Tensor, ...]   # the last <= 4 eps estimates, newest last
    cur_sample: torch.Tensor
    counter: int                    # transfers taken so far


def pndm_transfer(sched: DiffusionSchedule, sample: torch.Tensor,
                  eps: torch.Tensor, t: int, t_prev: int) -> torch.Tensor:
    """The PNDM transfer x_t -> x_{t_prev} for an eps estimate (Liu et al.
    2022 eq. 11; diffusers PNDMScheduler._get_prev_sample)."""
    acp_t, acp_prev = _acp(sched, t, t_prev)
    sample_coeff = torch.sqrt(acp_prev / acp_t)
    denom = (acp_t * torch.sqrt(1 - acp_prev)
             + torch.sqrt(acp_t * acp_prev * (1 - acp_t)))
    eps_coeff = (acp_prev - acp_t) / denom
    return sample_coeff * sample - eps_coeff * eps


def pndm_plms_step(sched: DiffusionSchedule, eps: torch.Tensor, t: int,
                   t_prev: int, sample: torch.Tensor, state: PNDMState):
    """One linear multistep (PLMS) transfer: eps is appended to the
    history, and the first three steps of an empty history use the
    1-, 2- and 3-step Adams-Bashforth weights. -> (x_{t_prev}, state)."""
    ets = (state.ets + (eps,))[-4:]
    n = len(ets)
    if n == 1:
        eps_avg = ets[-1]
    elif n == 2:
        eps_avg = (3 * ets[-1] - ets[-2]) / 2
    elif n == 3:
        eps_avg = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
    else:
        eps_avg = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3]
                   - 9 * ets[-4]) / 24
    prev = pndm_transfer(sched, sample, eps_avg, t, t_prev)
    return prev, PNDMState(ets=ets, cur_sample=prev,
                           counter=state.counter + 1)


def pndm_prk_step(sched: DiffusionSchedule,
                  eps_fn: Callable[[torch.Tensor, int], torch.Tensor],
                  sample: torch.Tensor, t: int, t_prev: int,
                  state: PNDMState):
    """One pseudo Runge-Kutta transfer x_t -> x_{t_prev}, four eps_fn
    (UNet) evaluations at t, the midpoint twice and t_prev, weighted
    1/6-1/3-1/3-1/6; the first estimate joins the history, so PLMS starts
    from a full one after three of these. -> (x_{t_prev}, state)."""
    t_mid = (t + t_prev) // 2 if t_prev >= 0 else t // 2
    e1 = eps_fn(sample, t)
    e2 = eps_fn(pndm_transfer(sched, sample, e1, t, t_mid), t_mid)
    e3 = eps_fn(pndm_transfer(sched, sample, e2, t, t_mid), t_mid)
    e4 = eps_fn(pndm_transfer(sched, sample, e3, t, t_prev), t_prev)
    eps_prime = (e1 + 2.0 * e2 + 2.0 * e3 + e4) / 6.0
    prev = pndm_transfer(sched, sample, eps_prime, t, t_prev)
    return prev, PNDMState(ets=(state.ets + (e1,))[-4:], cur_sample=prev,
                           counter=state.counter + 1)
