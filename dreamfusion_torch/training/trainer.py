"""Training loop, train side (counterpart of
dreamfusion_tpu/training/trainer.py; reference nerf/utils.py:151-968).

One step: cameras -> shading schedule -> occupancy-grid render (fused
compositor) -> SDS guidance -> regularizers -> backward -> Adam. Every 16
steps the occupancy grid is refreshed and the adaptive sample budgets are
re-picked from the last step's count statistics, with the JAX package's
bucket ladder (``_pick_K_bucket``), so a step computes what the JAX step
computes. PyTorch runs eagerly, so no per-bucket program cache is kept.

Every draw of a step can be injected through ``draws`` (see
``make_grads_fn``); absent draws come from the trainer's generators.

The step's parts run under ``torch.profiler.record_function`` spans
(step/cameras, step/render, step/guidance, step/backward, step/optimizer,
grid_refresh); chip_smoke.py's profile phase reads their device time.
Outside a profiler a span costs a few microseconds of host time.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

import torch
from torch.profiler import record_function

from dreamfusion_torch import cameras
from dreamfusion_torch.config import Config
from dreamfusion_torch.device import resolve_device
from dreamfusion_torch.guidance import Guidance, build_guidance
from dreamfusion_torch.models.networks import (SHADING_ALBEDO,
                                               SHADING_LAMBERTIAN,
                                               SHADING_TEXTURELESS,
                                               NeRFGridNetwork, build_model,
                                               make_field_fns)
from dreamfusion_torch.ops.marching import (GridState, init_grid_state,
                                            refresh_partial, render_grid,
                                            update_grid)
from dreamfusion_torch.training.optimizers import build_optimizer

K_LADDER = (16, 32, 48, 64, 96, 128, 192, 256)
SDS_DRAWS = ("vae_eps", "t", "noise")


def _shading_schedule(step: int, albedo_iters: int, shade_u: float):
    """(shading_code, ambient_ratio) for this step (nerf/utils.py:346-359):
    albedo until albedo_iters, then 20% albedo / 40% textureless / 40%
    lambertian from the uniform draw shade_u."""
    if step < albedo_iters or shade_u > 0.8:
        code = SHADING_ALBEDO
    elif shade_u > 0.4:
        code = SHADING_TEXTURELESS
    else:
        code = SHADING_LAMBERTIAN
    return code, 1.0 if code == SHADING_ALBEDO else 0.1


def _pick_K_bucket(q95: float, cap: int) -> int:
    """Smallest ladder bucket covering the 95th-percentile count."""
    for b in K_LADDER:
        if b >= min(q95, cap):
            return min(b, cap)
    return cap


def make_grads_fn(cfg: Config, model: NeRFGridNetwork, guidance: Guidance,
                  grid_K: Optional[int] = None,
                  compact_M: Optional[int] = None):
    """grads_fn(step, text_z, grid_state, draws=None, generator=None,
    host_generator=None) -> (loss, metrics); leaves the gradients in the
    parameters' .grad.

    draws (all optional): radius, u_sphere, u_orbit, u_select, fov (camera),
    shade_u (float), bg [B*h*w, 3], light_n [3], perturb_u [B*h*w],
    smooth_n, and the SDS draws vae_eps, t, noise."""
    if not cfg.grid_ray:
        raise NotImplementedError("only the occupancy-grid renderer (-O) is "
                                  "ported; the stratified renderer is queued")
    compute_orient = cfg.lambda_orient > 0
    compute_smooth = cfg.lambda_smooth > 0
    grid_K = grid_K or cfg.grid_K

    def grads_fn(step: int, text_z: torch.Tensor, grid_state: GridState,
                 draws: Optional[Dict[str, Any]] = None,
                 generator: Optional[torch.Generator] = None,
                 host_generator: Optional[torch.Generator] = None):
        draws = draws or {}
        dev = text_z.device
        with record_function("step/cameras"):
            batch = cameras.sample_train_batch(cfg, generator=generator,
                                               device=dev, draws=draws)
        B, N = cfg.batch_size, cfg.h * cfg.w
        rays_o = batch["rays_o"].reshape(B * N, 3)
        rays_d = batch["rays_d"].reshape(B * N, 3)
        shade_u = draws.get("shade_u")
        if shade_u is None:
            shade_u = torch.rand((), generator=host_generator).item()
        code, ratio = _shading_schedule(step, cfg.albedo_iters, float(shade_u))
        bg_color = draws.get("bg")
        if bg_color is None:
            bg_color = torch.rand(B * N, 3, generator=generator, device=dev)

        fns = make_field_fns(model)
        if not compute_smooth:
            fns = fns._replace(normal=None)
        with record_function("step/render"):
            out = render_grid(
                fns, grid_state, rays_o, rays_d, bound=cfg.bound,
                min_near=cfg.min_near, max_steps=cfg.max_steps, K=grid_K,
                bg_radius=cfg.bg_radius,
                ambient_ratio=ratio, shading_code=code, bg_color=bg_color,
                perturb=True,
                compute_normal_losses=compute_orient or compute_smooth,
                compact_M=compact_M, generator=generator,
                light_n=draws.get("light_n"),
                perturb_u=draws.get("perturb_u"),
                smooth_n=draws.get("smooth_n"))

        pred_rgb = out["image"].reshape(B, cfg.h, cfg.w, 3)
        pred_ws = out["weights_sum"].reshape(B, N)
        if cfg.dir_text:
            tz = text_z[batch["dir"]]
        else:
            tz = text_z[:1].expand((B,) + text_z.shape[1:])
        sds_draws = {k: draws[k] for k in SDS_DRAWS if k in draws}
        with record_function("step/guidance"):
            g_loss = guidance.loss(tz, pred_rgb, sds_draws, generator)

        loss = g_loss
        metrics = {"loss_guidance": g_loss.detach()}
        if cfg.lambda_opacity != 0:
            l_op = (pred_ws ** 2).mean()
            loss = loss + cfg.lambda_opacity * l_op
            metrics["loss_opacity"] = l_op.detach()
        if cfg.lambda_entropy > 0:
            a = torch.clamp(pred_ws, 1e-5, 1 - 1e-5)
            l_ent = (-a * torch.log2(a) - (1 - a) * torch.log2(1 - a)).mean()
            loss = loss + cfg.lambda_entropy * l_ent
            metrics["loss_entropy"] = l_ent.detach()
        if compute_orient and "loss_orient" in out:
            loss = loss + cfg.lambda_orient * out["loss_orient"]
            metrics["loss_orient"] = out["loss_orient"].detach()
        if compute_smooth and "loss_smooth" in out:
            loss = loss + cfg.lambda_smooth * out["loss_smooth"]
            metrics["loss_smooth"] = out["loss_smooth"].detach()
        metrics["mean_opacity"] = pred_ws.detach().mean()
        metrics["shading_code"] = code
        for k in ("count_q95", "live_q95", "mean_count", "n_field_samples"):
            metrics[k] = out[k]

        for p in model.parameters():
            p.grad = None
        with record_function("step/backward"):
            loss.backward()
        metrics["loss"] = loss.detach()
        return loss.detach(), metrics

    return grads_fn


class Trainer:
    """Train-side experiment driver: workspace, occupancy grid, adaptive
    budgets, checkpoints. ``evaluate`` and ``test`` belong to the next slice
    of the port and raise."""

    def __init__(self, name: str, cfg: Config,
                 model: Optional[NeRFGridNetwork] = None,
                 guidance: Optional[Guidance] = None,
                 workspace: Optional[str] = None,
                 use_checkpoint: Optional[str] = None,
                 device: Optional[str] = None):
        self.name = name
        self.cfg = cfg
        self.device = resolve_device(device or cfg.device)
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.host_gen = torch.Generator().manual_seed(cfg.seed)
        self.model = model if model is not None else build_model(
            cfg, self.device, self.gen)
        self.guidance = guidance if guidance is not None else build_guidance(
            cfg, self.device, self.gen)
        self.workspace = workspace or cfg.workspace
        os.makedirs(self.workspace, exist_ok=True)
        self.ckpt_dir = os.path.join(os.path.abspath(self.workspace),
                                     "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.log_path = os.path.join(self.workspace, f"log_{name}.jsonl")

        self.opt, self.lr_sched = build_optimizer(cfg, self.model)
        self.step = 0
        self.grid_state = init_grid_state(cfg.cascade, cfg.grid_size,
                                          self.device)
        self.text_z = self._prepare_text_embeddings()
        self._cur_grid_K = cfg.grid_K
        self._cur_compact_M: Optional[int] = None
        self._mean_count_ema: Optional[float] = None
        self.loss_history = []
        use_ckpt = use_checkpoint if use_checkpoint is not None else cfg.ckpt
        if use_ckpt != "scratch":
            self.load_checkpoint(use_ckpt)

    # -- text -----------------------------------------------------------------

    def _prepare_text_embeddings(self) -> torch.Tensor:
        """Per-direction prompts "<text>, <dir> view" (nerf/utils.py:290-319)."""
        cfg = self.cfg
        if cfg.text is None or self.guidance.name == "none":
            return torch.zeros(6 if cfg.dir_text else 1, 1, device=self.device)
        if not cfg.dir_text:
            return self.guidance.get_text_embeds([cfg.text], [cfg.negative])
        zs = []
        for d in cameras.DIR_TEXTS:
            neg = cfg.negative
            if cfg.suppress_face and d in ("back", "side", "overhead", "bottom"):
                neg = (neg + ", " if neg else "") + "face"
            zs.append(self.guidance.get_text_embeds([f"{cfg.text}, {d} view"],
                                                    [neg]))
        return torch.cat(zs, dim=0)

    def log(self, record: Dict[str, Any]):
        with open(self.log_path, "a") as f:
            f.write(json.dumps(record) + "\n")

    # -- adaptive budgets (trainer.py:1081-1132) --------------------------------

    def _pick_grid_K_live(self, live_q95: float, count_q95: float,
                          cur_K: int) -> int:
        """Bucket from the live count; when it saturates the current bucket,
        grow one ladder step toward the count bucket."""
        count_b = _pick_K_bucket(count_q95, self.cfg.grid_K)
        if live_q95 >= 0.95 * cur_K and cur_K < count_b:
            for b in K_LADDER:
                if b > cur_K:
                    return min(b, count_b)
            return count_b
        return min(_pick_K_bucket(live_q95, self.cfg.grid_K), count_b)

    def _pick_compact_M(self, mean_count: float, K: int) -> Optional[int]:
        """Global sample budget from an EMA of the mean marching count;
        None when the bucket reaches K."""
        cfg = self.cfg
        ema = self._mean_count_ema
        ema = mean_count if ema is None else 0.5 * ema + 0.5 * mean_count
        self._mean_count_ema = ema
        m_per_ray = _pick_K_bucket(ema * cfg.grid_compact_slack, K)
        if m_per_ray >= K:
            return None
        return m_per_ray * cfg.batch_size * cfg.h * cfg.w

    def _repick_budgets(self, metrics: Dict[str, Any]) -> None:
        cfg = self.cfg
        new_K = self._pick_grid_K_live(float(metrics["live_q95"]),
                                       float(metrics["count_q95"]),
                                       self._cur_grid_K)
        new_M = None
        if cfg.grid_compact:
            new_M = self._pick_compact_M(float(metrics["mean_count"]), new_K)
        self._cur_grid_K, self._cur_compact_M = new_K, new_M

    # -- steps ----------------------------------------------------------------------

    def update_grid(self, refresh_idx: int,
                    jitter: Optional[torch.Tensor] = None) -> GridState:
        """One occupancy refresh (full for the first 4, then quarters)."""
        with record_function("grid_refresh"):
            self.grid_state = update_grid(
                self.model.density, self.grid_state, bound=self.cfg.bound,
                density_thresh=self.cfg.density_thresh,
                decay=self.cfg.grid_decay,
                partial=refresh_partial(refresh_idx), generator=self.gen,
                jitter=jitter)
        return self.grid_state

    def train_step(self, draws: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
        """One optimizer step at the current (K, M) budgets."""
        grads_fn = make_grads_fn(self.cfg, self.model, self.guidance,
                                 grid_K=self._cur_grid_K,
                                 compact_M=self._cur_compact_M)
        loss, metrics = grads_fn(self.step, self.text_z, self.grid_state,
                                 draws=draws, generator=self.gen,
                                 host_generator=self.host_gen)
        with record_function("step/optimizer"):
            self.opt.step()
            self.lr_sched.step()
        self.step += 1
        return metrics

    def train(self, max_steps: Optional[int] = None, log_interval: int = 50,
              checkpoint_at_end: bool = True):
        cfg = self.cfg
        max_steps = max_steps or cfg.iters
        t0 = time.time()
        metrics = None
        while self.step < max_steps:
            step = self.step
            if step % cfg.update_extra_interval == 0:
                self.update_grid(step // cfg.update_extra_interval)
                if cfg.grid_K_adaptive and metrics is not None:
                    self._repick_budgets(metrics)
            metrics = self.train_step()
            self.loss_history.append(metrics["loss"])
            if self.step % log_interval == 0 or self.step == max_steps:
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=self.step, time=time.time() - t0,
                           grid_K=self._cur_grid_K,
                           compact_M=self._cur_compact_M)
                self.log(rec)
            if self.step % (cfg.eval_interval * cfg.dataset_size) == 0:
                self.evaluate(step=self.step)
        if checkpoint_at_end:
            self.save_checkpoint()

    def evaluate(self, step: int = 0):
        raise NotImplementedError(
            "Trainer.evaluate (the staged 800^2 eval) belongs to slice 2 of "
            "the port (ROADMAP.md); raise --eval_interval to train past it")

    def test(self):
        raise NotImplementedError(
            "Trainer.test (the 360-degree orbit render) belongs to slice 2 of "
            "the port (ROADMAP.md)")

    # -- checkpoints ------------------------------------------------------------------

    def save_checkpoint(self) -> str:
        path = os.path.join(self.ckpt_dir, f"step_{self.step:08d}.pt")
        torch.save({
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": self.opt.state_dict(),
            "lr_sched": self.lr_sched.state_dict(),
            "grid_state": self.grid_state._asdict(),
            "budgets": (self._cur_grid_K, self._cur_compact_M,
                        self._mean_count_ema),
            "gen": self.gen.get_state(),
            "host_gen": self.host_gen.get_state(),
        }, path)
        ckpts = sorted(d for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_"))
        for old in ckpts[: -self.cfg.max_keep_ckpt]:
            os.remove(os.path.join(self.ckpt_dir, old))
        return path

    def load_checkpoint(self, which: str = "latest") -> bool:
        if which == "latest":
            ckpts = sorted(d for d in os.listdir(self.ckpt_dir)
                           if d.startswith("step_"))
            if not ckpts:
                return False
            path = os.path.join(self.ckpt_dir, ckpts[-1])
        else:
            path = which
            if not os.path.exists(path):
                return False
        ck = torch.load(path, map_location=self.device, weights_only=False)
        self.model.load_state_dict(ck["model"])
        self.opt.load_state_dict(ck["optimizer"])
        self.lr_sched.load_state_dict(ck["lr_sched"])
        self.grid_state = GridState(**{k: v.to(self.device)
                                       for k, v in ck["grid_state"].items()})
        (self._cur_grid_K, self._cur_compact_M,
         self._mean_count_ema) = ck["budgets"]
        self.gen.set_state(ck["gen"].cpu())
        self.host_gen.set_state(ck["host_gen"].cpu())
        self.step = int(ck["step"])
        return True
