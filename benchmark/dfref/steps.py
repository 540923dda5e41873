"""The training steps the benchmark's cells compare, written out in plain
PyTorch on the frozen copies beside this file:

- ``SDSStep``: one step of `-O` SDS training on the occupancy-grid renderer
  (the program's ``training/trainer.make_grads_fn`` for ``cfg.grid_ray``,
  then Adam with the table at 10x the LR under the LambdaLR decay);
- ``sds_loss``: Score Distillation Sampling as one scalar
  (``guidance/sd/sds.py``), with the UNet's CFG batch of two;
- ``GroupAdam`` and ``dvgo_step``: one DVGO pretraining step
  (``training/dvgo_trainer.py``).

Every draw is given by the caller; nothing here draws."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from dfref import cameras
from dfref.models.dvgo import dvgo_losses
from dfref.models.networks import (SHADING_ALBEDO, SHADING_LAMBERTIAN,
                                   SHADING_TEXTURELESS, make_field_fns)
from dfref.ops.marching import render_grid
from dfref.sd.scheduler import add_noise

LATENT_SCALE = 0.18215


def shading_schedule(step: int, albedo_iters: int, shade_u: float):
    """(shading code, ambient ratio): albedo before albedo_iters, then 20%
    albedo / 40% textureless / 40% lambertian by the uniform draw."""
    if step < albedo_iters or shade_u > 0.8:
        code = SHADING_ALBEDO
    elif shade_u > 0.4:
        code = SHADING_TEXTURELESS
    else:
        code = SHADING_LAMBERTIAN
    return code, 1.0 if code == SHADING_ALBEDO else 0.1


def sds_loss(unet, vae, sched, text_z, pred_rgb, draws, *,
             guidance_scale: float, latent_size: int = 64,
             scale: Optional[list] = None) -> torch.Tensor:
    """sum(detach(w (eps_hat - eps)) * latents): text_z [B, 2, 77, D]
    (uncond, cond), pred_rgb [B, H, W, 3]; draws vae_eps, t, noise. With
    `scale` (a list), appends ||w (eps_hat - eps)|| ||latents||, the bound
    of the sum's magnitude by Cauchy-Schwarz."""
    B = pred_rgb.shape[0]
    size = latent_size * 8
    img = F.interpolate(pred_rgb.permute(0, 3, 1, 2), size=(size, size),
                        mode="bilinear", align_corners=False)
    latents = vae.encode(2.0 * img.permute(0, 2, 3, 1) - 1.0,
                         eps=draws["vae_eps"]) * LATENT_SCALE
    t = draws["t"].long()
    noise = draws["noise"]
    with torch.no_grad():
        noisy = add_noise(sched, latents.detach(), noise, t)
        eps = unet(torch.cat([noisy, noisy]), torch.cat([t, t]),
                   torch.cat([text_z[:, 0], text_z[:, 1]]))
        eps_uncond, eps_text = eps[:B], eps[B:]
        eps_hat = eps_uncond + guidance_scale * (eps_text - eps_uncond)
        w = (1.0 - sched.alphas_cumprod[t]).reshape(B, 1, 1, 1)
        grad = w * (eps_hat - noise)
        if scale is not None:
            scale.append(float(torch.linalg.vector_norm(grad)
                               * torch.linalg.vector_norm(latents)))
    return (grad * latents).sum()


def leave_out_half(image: torch.Tensor, ws: torch.Tensor):
    """A planted fault: the second half of the rays left out of the
    render, their pixels white and their opacity 0."""
    half = image.shape[0] // 2
    return (torch.cat([image[:half], torch.ones_like(image[half:])]),
            torch.cat([ws[:half], torch.zeros_like(ws[half:])]))


class SDSStep:
    """One `-O` training step of the grid renderer at a fixed budget K,
    every slot queried, then Adam; the model, its occupancy grid and the SD modules
    are the caller's."""

    def __init__(self, cfg, model, unet, vae, sched, text_z,
                 latent_size: int = 64, fault: Optional[str] = None):
        self.cfg, self.model, self.latent_size = cfg, model, latent_size
        self.fault = fault
        self.unet, self.vae, self.sched, self.text_z = unet, vae, sched, text_z
        frozen = tuple(getattr(model, "frozen_prefixes", ()))
        enc, net = [], []
        for name, p in model.named_parameters():
            if frozen and name.startswith(frozen):
                p.requires_grad_(False)
                continue
            (enc if "embeddings" in name else net).append(p)
        groups = [g for g in ({"params": net, "lr": cfg.lr},
                              {"params": enc, "lr": cfg.lr * 10.0})
                  if g["params"]]
        self.opt = torch.optim.Adam(groups, betas=(cfg.adam_b1, cfg.adam_b2),
                                    eps=cfg.adam_eps)
        iters = cfg.iters
        self.sched_lr = torch.optim.lr_scheduler.LambdaLR(
            self.opt, lambda s: 0.1 ** min(s / iters, 1.0))

    def loss(self, step: int, grid_state, draws: Dict, K: int
             ) -> torch.Tensor:
        cfg, model = self.cfg, self.model
        batch = cameras.sample_train_batch(cfg, draws=draws)
        B, N = cfg.batch_size, cfg.h * cfg.w
        rays_o = batch["rays_o"].reshape(B * N, 3)
        rays_d = batch["rays_d"].reshape(B * N, 3)
        code, ratio = shading_schedule(step, cfg.albedo_iters,
                                       float(draws["shade_u"]))
        fns = make_field_fns(model)
        out = render_grid(fns, grid_state, rays_o, rays_d,
                          max_steps=cfg.max_steps, K=K, dt_gamma=0.0,
                          bound=cfg.bound,
                          min_near=cfg.min_near, bg_radius=cfg.bg_radius,
                          ambient_ratio=ratio, shading_code=code,
                          bg_color=draws["bg"], perturb=True,
                          compute_normal_losses=cfg.lambda_orient > 0,
                          light_n=draws["light_n"],
                          perturb_u=draws["perturb_u"])
        image, ws = out["image"], out["weights_sum"]
        if self.fault == "half_batch":     # a planted fault (calibration)
            image, ws = leave_out_half(image, ws)
            ws = ws[:ws.shape[0] // 2]
        pred_rgb = image.reshape(B, cfg.h, cfg.w, 3)
        pred_ws = ws.reshape(B, -1)
        tz = (self.text_z[batch["dir"]] if cfg.dir_text
              else self.text_z[:1].expand((B,) + self.text_z.shape[1:]))
        scale: list = []
        loss = sds_loss(self.unet, self.vae, self.sched, tz, pred_rgb, draws,
                        guidance_scale=cfg.guidance_scale,
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

    def step(self, step: int, grid_state, draws: Dict, K: int) -> float:
        """One step; returns the loss (``loss_scale`` then holds the
        magnitude it is judged against: the SDS term's Cauchy-Schwarz bound
        plus the loss's own size). Every trainable parameter gets a
        gradient (zeros where the loss does not reach it), as the
        program's step gives it."""
        loss = self.loss(step, grid_state, draws, K)
        self.opt.zero_grad(set_to_none=True)
        if loss.requires_grad:
            loss.backward()
        for p in self.model.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        self.opt.step()
        self.sched_lr.step()
        return float(loss.detach())


class GroupAdam:
    """Per-group Adam with the LR decay 0.1 ** (count / (decay * 1000)) and
    optional per-voxel update factors (training/dvgo_trainer.py)."""

    def __init__(self, stage: Dict, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.base = {"density": stage["lr_density"], "k0": stage["lr_k0"],
                     "rgbnet": stage["lr_rgbnet"]}
        self.decay_steps = stage["lrate_decay"] * 1000
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.state: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    @staticmethod
    def group(name: str) -> str:
        parts = name.split(".")
        if "density" in parts:
            return "density"
        if "k0" in parts:
            return "k0"
        return "rgbnet"

    @torch.no_grad()
    def step(self, module: torch.nn.Module) -> None:
        count = self.count
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for name, p in module.named_parameters():
            group = self.group(name)
            if self.base[group] <= 0 or p.grad is None:
                continue
            g = p.grad
            m, v = self.state.get(name, (torch.zeros_like(p),
                                         torch.zeros_like(p)))
            m = (1 - self.b1) * g + self.b1 * m
            v = (1 - self.b2) * (g * g) + self.b2 * v
            self.state[name] = (m, v)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            p.add_(-(self.base[group] * 0.1 ** (count / self.decay_steps)) * u)


def dvgo_step(field, opt: GroupAdam, rays_o, rays_d, viewdirs, target,
              jitter, *, near: float, far: float, bg, n_samples: int,
              stage: Dict) -> float:
    """One DVGO pretraining step (render, losses, backward, GroupAdam);
    returns the loss."""
    out = field.render(rays_o, rays_d, viewdirs, near=near, far=far,
                       bg=bg, n_samples=n_samples, jitter=jitter)
    loss, _ = dvgo_losses(out, target, weight_main=stage["weight_main"],
                          weight_entropy_last=stage["weight_entropy_last"],
                          weight_rgbper=stage["weight_rgbper"],
                          entropy_weight=stage["entropy_weight"])
    field.zero_grad(set_to_none=True)
    loss.backward()
    opt.step(field)
    return float(loss.detach())
