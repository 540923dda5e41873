"""Training loop, staged eval and 360-degree test render (counterpart of
dreamfusion_tpu/training/trainer.py; reference nerf/utils.py:151-968).

One step: cameras -> shading schedule -> render -> guidance (SDS or CLIP)
-> regularizers -> backward -> Adam. The renderer is the occupancy-grid
renderer (``-O``, ``cfg.grid_ray``; fused compositor) on the grid
backbone or the editing field (``--backbone dvgo``, whose pretrained scene
the Trainer loads at construction), or the stratified renderer (``-O2``,
renderer.render_stratified, path A) on the grid or vanilla backbone. On
the grid renderer the occupancy grid is refreshed every 16 steps and the
adaptive sample budgets are re-picked from the last step's count
statistics, with the JAX package's bucket ladder (``_pick_K_bucket``), so
a step computes what the JAX step computes. PyTorch runs eagerly, so no
per-bucket program cache is kept. A stratified Trainer has no grid state,
no refresh and no budgets.

Every draw of a step can be injected through ``draws`` (see
``make_grads_fn``); absent draws come from the trainer's generators.

Eval and test frames (``Trainer.evaluate`` / ``Trainer.test``) of the
stratified renderer render in chunks of ``cfg.max_ray_batch`` rays
(``make_eval_render``); those of the grid renderer render
through ``make_staged_grid_eval``: a classify pass over the pooled
occupancy grid (kernel D), a windowed march of the flagged ray groups with
a transmittance-live estimate (kernel W, one launch a frame), and a
compact shade per group composited on the compact buffer in one launch
(kernel C, the compact compositor), pasted into the frame by ray index.

``Trainer.advance`` is one step of ``train`` (the GUI's bursts take it),
``Trainer.reset_weights`` restarts the asset (the GUI's reset) and
``Trainer.save_mesh`` exports it as a textured mesh (export/mesh.py).

The step's parts run under ``dreamfusion_torch.trace`` spans
(step/cameras, step/render, step/guidance, step/backward, step/optimizer,
grid_refresh; their id the step), the eval frame's under eval/classify,
eval/bg, eval/march, eval/shade and eval/finish (their id the frame); the
benchmark's traced runs and chip_smoke.py's profile phase read them.
"""

from __future__ import annotations

import json
import os
import struct
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from dreamfusion_torch import cameras, trace
from dreamfusion_torch.config import Config
from dreamfusion_torch.device import resolve_device
from dreamfusion_torch.guidance import Guidance, build_guidance
from dreamfusion_torch.models.networks import (SHADING_ALBEDO,
                                               SHADING_LAMBERTIAN,
                                               SHADING_TEXTURELESS,
                                               _BaseNeRF, build_model,
                                               make_field_fns)
from dreamfusion_torch.ops.composite import near_far_from_aabb
from dreamfusion_torch.ops.marching import (SQRT3, GridState, MarchOut,
                                            coarse_hit_window,
                                            init_grid_state, march_rays,
                                            march_window_groups,
                                            max_pooled_stride, pool_occ,
                                            refresh_partial, render_grid,
                                            shade_march, update_grid)
from dreamfusion_torch.parallel import sharding
from dreamfusion_torch.renderer import render_rays_chunked, render_stratified
from dreamfusion_torch.training.optimizers import build_optimizer, ema_update

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


def _text_device(text_z) -> torch.device:
    """The device of text_z: a tensor, or SDXL's dict of context and pooled
    embedding."""
    return (text_z["context"] if isinstance(text_z, dict) else text_z).device


def make_grads_fn(cfg: Config, model: _BaseNeRF, guidance: Guidance,
                  grid_K: Optional[int] = None,
                  compact_M: Optional[int] = None):
    """grads_fn(step, text_z, grid_state, draws=None, generator=None,
    host_generator=None) -> (loss, metrics); leaves the gradients in the
    parameters' .grad. The renderer is the grid renderer when cfg.grid_ray
    (grid_K, compact_M and grid_state apply to it), else the stratified
    renderer (trainer.py:112-120; grid_state unused).

    draws (all optional): radius, u_sphere, u_orbit, u_select, fov, and
    with cfg.jitter_pose center_u, target_n, up_n (camera), shade_u
    (float), bg [B*h*w, 3], light_n [3], perturb_u ([B*h*w] on the
    grid renderer, [B*h*w, num_steps] on the stratified one), pdf_u
    [B*h*w, upsample_steps] (stratified), smooth_n, and the SDS draws
    vae_eps, t, noise."""
    compute_orient = cfg.lambda_orient > 0
    compute_smooth = cfg.lambda_smooth > 0
    grid_K = grid_K or cfg.grid_K

    def grads_fn(step: int, text_z: torch.Tensor, grid_state: GridState,
                 draws: Optional[Dict[str, Any]] = None,
                 generator: Optional[torch.Generator] = None,
                 host_generator: Optional[torch.Generator] = None):
        draws = draws or {}
        dev = _text_device(text_z)
        with trace.span("step/cameras"):
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
        with trace.span("step/render"):
            kw = dict(bound=cfg.bound, min_near=cfg.min_near,
                      bg_radius=cfg.bg_radius, ambient_ratio=ratio,
                      shading_code=code, bg_color=bg_color, perturb=True,
                      compute_normal_losses=compute_orient or compute_smooth,
                      generator=generator, light_n=draws.get("light_n"),
                      perturb_u=draws.get("perturb_u"),
                      smooth_n=draws.get("smooth_n"))
            if cfg.grid_ray:
                out = render_grid(fns, grid_state, rays_o, rays_d,
                                  max_steps=cfg.max_steps, K=grid_K,
                                  dt_gamma=cfg.dt_gamma,
                                  compact_M=compact_M, **kw)
            else:
                out = render_stratified(
                    fns, rays_o, rays_d, num_steps=cfg.num_steps,
                    upsample_steps=cfg.upsample_steps,
                    pdf_u=draws.get("pdf_u"), **kw)

        pred_rgb = out["image"].reshape(B, cfg.h, cfg.w, 3)
        pred_ws = out["weights_sum"].reshape(B, N)
        if isinstance(text_z, dict):        # SDXL: context and pooled
            idx = (batch["dir"] if cfg.dir_text
                   else torch.zeros(B, dtype=torch.long, device=dev))
            tz = {k: z[idx] for k, z in text_z.items()}
        elif cfg.dir_text:
            tz = text_z[batch["dir"]]
        else:
            tz = text_z[:1].expand((B,) + text_z.shape[1:])
        sds_draws = {k: draws[k] for k in SDS_DRAWS if k in draws}
        with trace.span("step/guidance"):
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
            if k in out:
                metrics[k] = out[k]

        for p in model.parameters():
            p.grad = None
        with trace.span("step/backward"):
            # on the editing field (frozen density) a loss can reach no
            # trainable parameter: without guidance, or on a textureless
            # step without a background net. All gradients are zero then
            if loss.requires_grad:
                loss.backward()
            # a parameter the loss did not reach gets zeros, not None, as
            # jax.grad gives it: Adam then decays its moments, advances its
            # count and moves it, as optax does
            for p in model.parameters():
                if p.requires_grad and p.grad is None:
                    p.grad = torch.zeros_like(p)
        metrics["loss"] = loss.detach()
        return loss.detach(), metrics

    return grads_fn


# optical-depth budget of the staged eval's live estimate: -ln(1e-4) times
# the JAX default margin 1.2 (trainer.py:521-536)
_LIVE_LOGT = 1.2 * 9.2103


def make_staged_grid_eval(cfg: Config, model: _BaseNeRF, H: int,
                          W: int):
    """The sorted, bucketed staged eval of the grid renderer
    (trainer.py:221-859, its default scatter-assembled frame): the
    counterpart of the reference's alive-ray compaction loop
    (nerf/renderer.py:496-532).

    1. classify: probe the pooled occupancy grid (pool_occ, factor 4, at a
       sound stride of 16; kernel D on the GPU) along every ray, or with
       several cascades the fine grid at stride 1; a zero count proves the
       ray empty. Sort the ray indices by (count, span of
       the emit window) and take each group's maxima to the host once;
    2. background for the whole frame;
    3. march every flagged group (from the densest end down to the first
       empty group) over the S-ladder length its span needs, with the
       sigma-EMA live estimate (margin 1.2) cutting samples past T ~ 1e-4
       (marching.march_window_groups: kernel W, all groups in one launch,
       on the GPU with a single cascade); the groups' stats come to the
       host in one transfer;
    4. shade each group: single cascade at a global compact budget of the
       group's mean live count (composite_compact: kernel C, the compact
       compositor), several cascades dense at the live bucket (kernel B);
       paste by ray index.

    With cfg.dt_gamma > 0 the coarse pass does not apply (cone stepping
    leaves the lattice), and the frame takes the march-everything fallback
    (trainer.py:644-651, 807-858): every group marched at K = grid_K
    (kernel F), the frame's rays sorted by emit count, ascending, each
    group's largest count taken to the host once, groups without an emit
    left to the background, the others shaded dense at the bucket of their
    largest count (kernel B-fwd) and pasted by ray index; no live cut and
    no kernel C, as in the JAX package.

    Groups hold cfg.max_ray_batch rays (4,096, the JAX default group); a
    frame whose H W is not a multiple of it is padded with rays that miss
    the box. cfg.aabb_infer (the GUI's box), when set, replaces +-bound as
    the rays' box. Returns render_frame(rays_o, rays_d, grid_state,
    shading_code=albedo, ambient_ratio=1.0, bg_color=None, light_d=None)
    -> {"image" [H,W,3], "depth" [H,W], "weights_sum" [H,W]}; its stages
    run under the spans eval/classify, eval/bg, eval/march, eval/shade and
    eval/finish."""
    group = cfg.max_ray_batch
    fns = make_field_fns(model, table_bf16=cfg.eval_table_bf16)._replace(
        normal=None)
    # the GUI's aabb_infer narrows the eval's ray box only, never the
    # train path's (trainer.py:280-283)
    box = (list(cfg.aabb_infer) if cfg.aabb_infer is not None
           else [-cfg.bound] * 3 + [cfg.bound] * 3)
    pool_factor = 4 if cfg.cascade == 1 else 1
    stride = (min(max_pooled_stride(cfg.max_steps, cfg.grid_size,
                                    pool_factor), 16)
              if pool_factor > 1 else 1)
    dt_lattice = 2.0 * SQRT3 / cfg.max_steps
    cone = cfg.dt_gamma > 0
    S_ladder = sorted({max(cfg.max_steps // 8, 1), cfg.max_steps // 4,
                       (3 * cfg.max_steps) // 8, cfg.max_steps // 2,
                       (5 * cfg.max_steps) // 8, (3 * cfg.max_steps) // 4,
                       cfg.max_steps})

    def classify(occ, o, d, aabb):
        """Coarse hit counts and emit windows, the sort by (count, span),
        and each group's maxima -> (perm, t_lo, gspan [groups] on the
        device, gmax [groups] (count) on the host)."""
        grid = pool_occ(occ, pool_factor) if pool_factor > 1 else occ
        nears, fars = near_far_from_aabb(o, d, aabb, cfg.min_near)
        counts, t_lo, t_hi = coarse_hit_window(
            grid, o, d, nears, fars, bound=cfg.bound,
            max_steps=cfg.max_steps, stride=stride)
        span = torch.ceil((t_hi - t_lo) / dt_lattice) + 2.0
        key = counts.float() * 4096.0 + torch.clamp(span, max=4095.0)
        perm = torch.sort(key, stable=True).indices
        gmax = counts.float()[perm].reshape(-1, group).amax(1)
        gspan = span[perm].reshape(-1, group).amax(1)
        return perm, t_lo, gspan, gmax.cpu()

    def march_all(occ, o, d, aabb):
        """The fallback's march: each group of rays at K = grid_K, the
        sort by emit count and each group's largest count on the host.
        Returns (MarchOut, nears, fars, perm, gmax [groups] host)."""
        parts = []
        for s in range(0, o.shape[0], group):
            o_g, d_g = o[s:s + group], d[s:s + group]
            nears, fars = near_far_from_aabb(o_g, d_g, aabb, cfg.min_near)
            parts.append((march_rays(occ, o_g, d_g, nears, fars,
                                     bound=cfg.bound,
                                     max_steps=cfg.max_steps, K=cfg.grid_K,
                                     dt_gamma=cfg.dt_gamma), nears, fars))
        m = MarchOut(*(torch.cat([p[0][i] for p in parts]) for i in range(4)))
        nears = torch.cat([p[1] for p in parts])
        fars = torch.cat([p[2] for p in parts])
        perm = torch.sort(m.counts, stable=True).indices
        gmax = m.counts[perm].reshape(-1, group).amax(1).cpu()
        return m, nears, fars, perm, gmax

    @torch.no_grad()
    def render_frame(rays_o, rays_d, grid_state: GridState,
                     shading_code: int = SHADING_ALBEDO,
                     ambient_ratio: float = 1.0, bg_color=None, light_d=None):
        dev = rays_o.device
        N = H * W
        Np = N + (-N) % group
        if light_d is None:
            light_d = cameras.safe_normalize(rays_o[0])
        aabb = torch.tensor(box, dtype=torch.float32, device=dev)
        o = torch.cat([rays_o, rays_o.new_zeros(Np - N, 3)])
        d = torch.cat([rays_d, rays_d.new_ones(Np - N, 3) / 3 ** 0.5])
        if not cone:
            with trace.span("eval/classify"):
                perm, t_lo, gspan, gmax = classify(grid_state.occ, o, d,
                                                   aabb)
        with trace.span("eval/bg"):
            if cfg.bg_radius > 0:
                image = model.background(d)
            elif bg_color is not None:
                image = torch.as_tensor(bg_color, dtype=torch.float32,
                                        device=dev).expand(Np, 3).clone()
            else:
                image = torch.ones(Np, 3, device=dev)
            depth = torch.zeros(Np, device=dev)
            ws = torch.zeros(Np, device=dev)
        bg = (None if bg_color is None else torch.as_tensor(
            bg_color, dtype=torch.float32, device=dev).expand(group, 3))
        kw = dict(bound=cfg.bound, light_d=light_d,
                  ambient_ratio=ambient_ratio, shading_code=shading_code,
                  bg_radius=cfg.bg_radius, bg_color=bg)
        if cone:
            with trace.span("eval/march"):
                m, nears, fars, perm, gmax = march_all(grid_state.occ, o, d,
                                                       aabb)
            with trace.span("eval/shade"):
                for g in range(gmax.shape[0]):
                    if gmax[g] == 0:
                        continue               # the background alone
                    ridx = perm[g * group:(g + 1) * group]
                    valid = m.valid[ridx]
                    out = shade_march(
                        fns, MarchOut(m.ts[ridx], m.dts[ridx], valid,
                                      valid.sum(1)),
                        o[ridx], d[ridx], nears[ridx], fars[ridx],
                        K=_pick_K_bucket(float(gmax[g]), cfg.grid_K), **kw)
                    image[ridx] = out["image"]
                    depth[ridx] = out["depth"]
                    ws[ridx] = out["weights_sum"]
            return finish(image, depth, ws)
        with trace.span("eval/march"):
            flagged = 0
            for g in reversed(range(gmax.shape[0])):
                if gmax[g] == 0.0:
                    break                      # sorted: the rest is empty
                flagged += 1
            marched, stats = march_window_groups(
                grid_state, o, d, perm, t_lo, gspan, flagged, group=group,
                aabb=aabb, min_near=cfg.min_near,
                density_thresh=cfg.density_thresh, live_logt=_LIVE_LOGT,
                bound=cfg.bound, max_steps=cfg.max_steps, S_ladder=S_ladder,
                K=cfg.grid_K)
        with trace.span("eval/shade"):
            for (ridx, o_g, d_g, m, nears, fars), (glive, gcount, ltot) \
                    in zip(marched, stats):
                if gcount == 0.0:
                    continue                   # flagged, but truly empty
                if ltot >= 0.0:
                    mb = _pick_K_bucket(max(ltot / group, 1.0)
                                        * cfg.grid_compact_slack, cfg.grid_K)
                    out = shade_march(fns, m, o_g, d_g, nears, fars,
                                      K=cfg.grid_K, compact_M=mb * group,
                                      compact_composite=True, **kw)
                else:
                    Kb = _pick_K_bucket(max(glive, 1.0), cfg.grid_K)
                    out = shade_march(fns, m, o_g, d_g, nears, fars, K=Kb,
                                      **kw)
                image[ridx] = out["image"]
                depth[ridx] = out["depth"]
                ws[ridx] = out["weights_sum"]
        return finish(image, depth, ws)

    def finish(image, depth, ws):
        N = H * W
        with trace.span("eval/finish"):
            return {"image": image[:N].reshape(H, W, 3),
                    "depth": depth[:N].reshape(H, W),
                    "weights_sum": ws[:N].reshape(H, W)}

    return render_frame


def make_eval_render(cfg: Config, model: _BaseNeRF, H: int, W: int,
                     dp: Optional[sharding.DataParallel] = None):
    """Full-frame eval renderer: white background unless the model has a
    background net, albedo shading, no perturbation (trainer.py:862-934).
    On one rank the grid renderer takes the staged eval. The stratified
    renderer renders chunks of min(H W, cfg.max_ray_batch) rays with
    light_d = normalize(rays_o[0]), the deterministic sample_pdf grid and
    the f32 table (the bf16 view is the staged grid eval's only).

    With a data-parallel group of more than one rank (dp) the frame's rays
    are sharded over the ranks (sharding.shard_rays_render) and each rank
    renders its slice in chunks of min(max(H W // ranks, 1),
    cfg.max_ray_batch) rays at the default shading, as the JAX package's
    mesh path does (trainer.py:872, 895, 924): the grid renderer through
    render_grid at K = grid_K, not the staged eval; the shading arguments
    are then ignored. The grid renderer's rays take cfg.aabb_infer as
    their box when it is set; the stratified renderer keeps +-bound, as in
    the JAX package. Returns render_frame with make_staged_grid_eval's
    signature; the frame runs under the span eval/render."""
    n = dp.world_size if dp is not None else 1
    if cfg.grid_ray and n == 1:
        return make_staged_grid_eval(cfg, model, H, W)
    fns = make_field_fns(model)._replace(normal=None)
    chunk = min(max(H * W // n, 1), cfg.max_ray_batch)

    @torch.no_grad()
    def render_frame(rays_o, rays_d, grid_state=None,
                     shading_code: int = SHADING_ALBEDO,
                     ambient_ratio: float = 1.0, bg_color=None, light_d=None):
        dev = rays_o.device
        if n > 1:
            shading_code, ambient_ratio = SHADING_ALBEDO, 1.0
            bg_color = light_d = None

        def render_chunk(o, d, ld):
            bg = (None if bg_color is None else torch.as_tensor(
                bg_color, dtype=torch.float32, device=dev).expand(
                    o.shape[0], 3))
            kw = dict(bound=cfg.bound, min_near=cfg.min_near,
                      bg_radius=cfg.bg_radius, ambient_ratio=ambient_ratio,
                      shading_code=shading_code, bg_color=bg, perturb=False,
                      light_d=ld)
            if cfg.grid_ray:
                out = render_grid(fns, grid_state, o, d,
                                  max_steps=cfg.max_steps, K=cfg.grid_K,
                                  dt_gamma=cfg.dt_gamma,
                                  aabb=cfg.aabb_infer, **kw)
            else:
                out = render_stratified(
                    fns, o, d, num_steps=cfg.num_steps,
                    upsample_steps=cfg.upsample_steps, **kw)
            return {k: out[k] for k in ("image", "depth", "weights_sum")}

        def render_rays(o, d):
            ld = cameras.safe_normalize(o[0]) if light_d is None else light_d
            return render_rays_chunked(
                lambda oc, dc: render_chunk(oc, dc, ld), o, d, chunk)

        if n > 1:
            render_rays = sharding.shard_rays_render(render_rays, dp)
        with trace.span("eval/render"):
            out = render_rays(rays_o, rays_d)
        return {"image": out["image"].reshape(H, W, 3),
                "depth": out["depth"].reshape(H, W),
                "weights_sum": out["weights_sum"].reshape(H, W)}

    return render_frame


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4] (RGBA) -> an 8-bit
    PNG file, with zlib and struct only."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, -1)],
                         axis=1).tobytes()          # filter byte 0 per row

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    channels = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[channels]        # PNG colour type
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


class Trainer:
    """Experiment runner: workspace, occupancy grid and adaptive budgets
    (grid renderer), checkpoints, eval dumps and the 360-degree test render
    (API of the reference Trainer, nerf/utils.py:151-968). ``renderer`` is
    "grid" or "stratified", by cfg.grid_ray (trainer.py:952).

    With cfg.ema_decay the Trainer keeps f32 EMA copies of the parameters
    (``ema``, initialised to them and updated after every optimizer step,
    trainer.py:196-202); checkpoints carry them, and the "best" snapshot
    stores them as its model weights (trainer.py:1333-1346).

    ``parallel`` (a sharding.DataParallel, one per rank; main() spawns the
    ranks for cfg.n_devices > 1) makes the Trainer one rank of a
    data-parallel run: the model and grid start from rank 0's, the step's
    draws come from generators of the rank's own, the gradients, loss and
    metrics are averaged over the ranks before the update (so every rank
    picks the same budgets and holds the same parameters), rank 0 refreshes
    the occupancy grid and broadcasts it, eval frames are ray-sharded, and
    only rank 0 writes logs, checkpoints and frames. With one rank the
    generators and draw streams are those of a plain run."""

    def __init__(self, name: str, cfg: Config,
                 model: Optional[_BaseNeRF] = None,
                 guidance: Optional[Guidance] = None,
                 workspace: Optional[str] = None,
                 use_checkpoint: Optional[str] = None,
                 device: Optional[str] = None,
                 parallel: Optional[sharding.DataParallel] = None):
        self.name = name
        self.cfg = cfg
        self.dp = parallel if parallel and parallel.world_size > 1 else None
        if parallel is not None:
            self.device = parallel.device
        else:
            self.device = resolve_device(device or cfg.device)
            if sharding.world_size(cfg.n_devices, self.device) > 1:
                raise ValueError(
                    f"n_devices={cfg.n_devices} runs one process per rank: "
                    "start it through dreamfusion_torch.main (or give each "
                    "rank's Trainer its sharding.DataParallel)")
        self.rank = parallel.rank if parallel is not None else 0
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.host_gen = torch.Generator().manual_seed(cfg.seed)
        # the step's draws: a rank's own stream under data parallelism
        # (the JAX package folds its key by the device index)
        self.step_gen, self.step_host_gen = self.gen, self.host_gen
        if self.dp is not None:
            rank_seed = cfg.seed * 1_000_003 + 1 + self.rank
            self.step_gen = torch.Generator(
                device=self.device).manual_seed(rank_seed)
            self.step_host_gen = torch.Generator().manual_seed(rank_seed)
        self.model = model if model is not None else build_model(
            cfg, self.device, self.gen)
        if cfg.pretrained_dvgo and hasattr(self.model, "load_pretrained"):
            # a model built above holds the file's state already
            self.model.load_pretrained(
                cfg.pretrained_dvgo if model is not None else None)
        if self.dp is not None:
            sharding.broadcast_module(self.model, self.dp)
        self.guidance = guidance if guidance is not None else build_guidance(
            cfg, self.device, self.gen)
        self.workspace = workspace or cfg.workspace
        self.renderer = "grid" if cfg.grid_ray else "stratified"
        os.makedirs(self.workspace, exist_ok=True)
        self.ckpt_dir = os.path.join(os.path.abspath(self.workspace),
                                     "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.log_path = os.path.join(self.workspace, f"log_{name}.jsonl")

        self.opt, self.lr_sched = build_optimizer(cfg, self.model)
        self.ema: Optional[Dict[str, torch.Tensor]] = (
            {k: p.detach().float().clone()
             for k, p in self.model.named_parameters()}
            if cfg.ema_decay else None)
        self.step = 0
        self.grid_state: Optional[GridState] = (
            init_grid_state(cfg.cascade, cfg.grid_size, self.device)
            if self.renderer == "grid" else None)
        self.text_z = self._prepare_text_embeddings()
        self._cur_grid_K = cfg.grid_K
        self._cur_compact_M: Optional[int] = None
        self._mean_count_ema: Optional[float] = None
        self.loss_history = []
        self._eval_render = None
        self.stats: Dict[str, Any] = {"valid_loss": [], "best_result": None}
        use_ckpt = use_checkpoint if use_checkpoint is not None else cfg.ckpt
        if use_ckpt != "scratch":
            self.load_checkpoint(use_ckpt)

    # -- text -----------------------------------------------------------------

    def _prepare_text_embeddings(self):
        """Per-direction prompts "<text>, <dir> view" (nerf/utils.py:290-319):
        [n, 2, 77, D], or with SDXL a dict of it ("context") and the pooled
        embedding [n, 2, P] ("pooled"), indexed together."""
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
        if isinstance(zs[0], dict):         # SDXL: context and pooled
            return {k: torch.cat([z[k] for z in zs]) for k in zs[0]}
        return torch.cat(zs, dim=0)

    def log(self, record: Dict[str, Any]):
        if self.rank != 0:
            return
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
        """One occupancy refresh (full for the first 4, then quarters); under
        data parallelism rank 0's, broadcast to the other ranks."""
        with trace.span("grid_refresh"):
            if self.rank == 0:
                self.grid_state = update_grid(
                    self.model.density, self.grid_state,
                    bound=self.cfg.bound,
                    density_thresh=self.cfg.density_thresh,
                    decay=self.cfg.grid_decay,
                    partial=refresh_partial(refresh_idx), generator=self.gen,
                    jitter=jitter)
            if self.dp is not None:
                for t in self.grid_state:
                    self.dp.broadcast(t)
        return self.grid_state

    def train_step(self, draws: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
        """One optimizer step at the current (K, M) budgets (its spans'
        id: the step)."""
        trace.set_id(self.step)
        grads_fn = make_grads_fn(self.cfg, self.model, self.guidance,
                                 grid_K=self._cur_grid_K,
                                 compact_M=self._cur_compact_M)
        if self.dp is not None:
            grads_fn = sharding.data_parallel_grads(grads_fn, self.model,
                                                    self.dp)
        loss, metrics = grads_fn(self.step, self.text_z, self.grid_state,
                                 draws=draws, generator=self.step_gen,
                                 host_generator=self.step_host_gen)
        with trace.span("step/optimizer"):
            self.opt.step()
            self.lr_sched.step()
            if self.ema is not None:
                ema_update(self.ema, dict(self.model.named_parameters()),
                           self.cfg.ema_decay)
        self.step += 1
        return metrics

    def advance(self, last_metrics: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
        """One step of train(): on the grid renderer, every
        update_extra_interval steps an occupancy refresh and (adaptive
        budgets) a re-pick from the last step's metrics; then train_step."""
        cfg = self.cfg
        if (self.renderer == "grid"
                and self.step % cfg.update_extra_interval == 0):
            self.update_grid(self.step // cfg.update_extra_interval)
            if cfg.grid_K_adaptive and last_metrics is not None:
                self._repick_budgets(last_metrics)
        return self.train_step()

    def train(self, max_steps: Optional[int] = None, log_interval: int = 50,
              checkpoint_at_end: bool = True):
        cfg = self.cfg
        max_steps = max_steps or cfg.iters
        t0 = time.time()
        metrics = None
        while self.step < max_steps:
            metrics = self.advance(metrics)
            self.loss_history.append(metrics["loss"])
            if self.step % log_interval == 0 or self.step == max_steps:
                rec = {k: float(v) for k, v in metrics.items()}
                rec.update(step=self.step, time=time.time() - t0,
                           grid_K=self._cur_grid_K,
                           compact_M=self._cur_compact_M)
                self.log(rec)
            if self.step % (cfg.eval_interval * cfg.dataset_size) == 0:
                self.evaluate(step=self.step)
                self.save_checkpoint()
        if checkpoint_at_end:
            self.save_checkpoint()

    def reset_weights(self) -> None:
        """The GUI's reset (trainer.py:1025-1050; nerf/gui.py:221-233): the
        model re-initialised from the trainer's generator (a --backbone
        dvgo field reloads its pretrained scene), a new optimizer and
        schedule (Adam or Shampoo, no state kept), step 0, the EMA restarted
        from the new weights, a fresh occupancy grid and the first step's
        sample budgets. Under data parallelism every rank draws the same
        init from its generator, and rank 0's is broadcast."""
        cfg = self.cfg
        self.model.reset_parameters(self.gen)
        if cfg.pretrained_dvgo and hasattr(self.model, "load_pretrained"):
            self.model.load_pretrained(cfg.pretrained_dvgo)
        if self.dp is not None:
            sharding.broadcast_module(self.model, self.dp)
        self.opt, self.lr_sched = build_optimizer(cfg, self.model)
        if self.ema is not None:
            self.ema = {k: p.detach().float().clone()
                        for k, p in self.model.named_parameters()}
        self.step = 0
        if self.renderer == "grid":
            self.grid_state = init_grid_state(cfg.cascade, cfg.grid_size,
                                              self.device)
        self._cur_grid_K, self._cur_compact_M = cfg.grid_K, None
        self._mean_count_ema = None
        self.loss_history = []
        self.stats = {"valid_loss": [], "best_result": None}

    # -- evaluation / test (trainer.py:1216-1301) ---------------------------------

    def set_config(self, cfg: Config) -> None:
        """Replace the config between steps (the GUI's sliders) and drop
        the cached eval renderer, which is built from it."""
        self.cfg = cfg
        self._eval_render = None

    def _get_eval_render(self, H: int, W: int):
        if self._eval_render is None or self._eval_render[0] != (H, W):
            self._eval_render = ((H, W), make_eval_render(
                self.cfg, self.model, H, W, self.dp))
        return self._eval_render[1]

    def _render_orbit_frame(self, i: int, size: int, H: int, W: int):
        """Frame i of a size-frame orbit at H x W through make_eval_render
        (its spans' id: i)."""
        trace.set_id(i)
        batch = cameras.sample_test_batch(i, size, self.cfg, H=H, W=W,
                                          device=self.device)
        return self._get_eval_render(H, W)(
            batch["rays_o"][0], batch["rays_d"][0], self.grid_state)

    def _save_frame(self, out, path_rgb: str,
                    path_depth: Optional[str] = None) -> np.ndarray:
        """PNGs of the frame's image and, optionally, its depth scaled to
        [0, 255] (rank 0 only); returns the uint8 image."""
        rgb = (out["image"].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        if self.rank != 0:
            return rgb
        write_png(path_rgb, rgb)
        if path_depth:
            d = out["depth"].float().cpu().numpy()
            d = 255 * (d - d.min()) / max(d.max() - d.min(), 1e-6)
            write_png(path_depth, d.astype(np.uint8))
        return rgb

    def evaluate(self, step: int = 0, size: Optional[int] = None) -> float:
        """Validation frames + eval loss + best tracking (nerf/utils.py:
        757-845). The eval loss is lambda_entropy x the binary entropy of
        weights_sum (nerf/utils.py:425-431); a new best saves the best
        checkpoint."""
        cfg = self.cfg
        size = size or cfg.val_size
        vdir = os.path.join(self.workspace, "validation")
        os.makedirs(vdir, exist_ok=True)
        total = 0.0
        for i in range(size):
            out = self._render_orbit_frame(i, size, cfg.H, cfg.W)
            a = torch.clamp(out["weights_sum"], 1e-5, 1 - 1e-5)
            ent = (-a * torch.log2(a) - (1 - a) * torch.log2(1 - a)).mean()
            total += cfg.lambda_entropy * float(ent)
            stem = os.path.join(vdir, f"{self.name}_{step:06d}_{i:04d}")
            self._save_frame(out, f"{stem}_rgb.png", f"{stem}_depth.png")
        avg = total / max(size, 1)
        self.stats["valid_loss"].append(avg)
        best = self.stats["best_result"]
        if best is None or avg < best:
            self.log({"step": step, "new_best": avg, "prev_best": best})
            self.stats["best_result"] = avg
            self.save_checkpoint(best=True)
        return avg

    def test(self, size: Optional[int] = None,
             write_video: bool = True) -> List[np.ndarray]:
        """360-degree orbit render (nerf/utils.py:507-555): PNG frames, and
        an mp4 (or, failing that, a GIF) when imageio can be imported."""
        size = size or self.cfg.test_size
        tdir = os.path.join(self.workspace, "results")
        os.makedirs(tdir, exist_ok=True)
        frames = []
        for i in range(size):
            out = self._render_orbit_frame(i, size, self.cfg.H, self.cfg.W)
            frames.append(self._save_frame(
                out, os.path.join(tdir, f"{self.name}_{i:04d}_rgb.png")))
        if write_video and frames and self.rank == 0:
            try:
                import imageio
            except ImportError:
                print("test: video skipped (imageio is not installed); the "
                      f"frames are PNGs in {tdir}")
                self.log({"video": "skipped: imageio is not installed"})
                return frames
            try:
                imageio.mimwrite(os.path.join(tdir, f"{self.name}_rgb.mp4"),
                                 frames, fps=25)
            except Exception:
                imageio.mimwrite(os.path.join(tdir, f"{self.name}_rgb.gif"),
                                 frames, fps=25, loop=0)
        return frames

    def save_mesh(self, resolution: int = 256, chunk: int = 262144,
                  timings: Optional[Dict[str, float]] = None,
                  stats: Optional[Dict[str, Any]] = None) -> str:
        """Textured mesh of the field into <workspace>/mesh (mesh.obj,
        mesh.mtl, albedo.png with a 1024^2 texture; trainer.py:1303-1326):
        the field's density
        on the resolution^3 lattice, queried on the trainer's device in
        chunks of `chunk` points, cut at min(mean density of the occupancy
        grid, density_thresh) (density_thresh without a grid). Returns the
        .obj path; timings and stats as export_textured_mesh."""
        from dreamfusion_torch.export.mesh import export_textured_mesh

        mean_density = (None if self.grid_state is None
                        else float(self.grid_state.mean_density))
        return export_textured_mesh(
            self.model.density, os.path.join(self.workspace, "mesh"),
            resolution=resolution, density_thresh=self.cfg.density_thresh,
            mean_density=mean_density, chunk=chunk,
            device=self.device, timings=timings, stats=stats)

    # -- checkpoints ------------------------------------------------------------------

    def save_checkpoint(self, best: bool = False) -> Optional[str]:
        """Rotating step checkpoints; best=True writes the separate "best"
        snapshot, which rotation leaves alone (nerf/utils.py:847-968), with
        the EMA weights as its model weights when the EMA is on. Rank 0
        writes; the other ranks return None."""
        if self.rank != 0:
            return None
        name = "best.pt" if best else f"step_{self.step:08d}.pt"
        path = os.path.join(self.ckpt_dir, name)
        model_sd = self.model.state_dict()
        if best and self.ema is not None:
            model_sd = {k: self.ema.get(k, v) for k, v in model_sd.items()}
        torch.save({
            "step": self.step,
            "model": model_sd,
            "ema": self.ema,
            "optimizer": self.opt.state_dict(),
            "lr_sched": self.lr_sched.state_dict(),
            "grid_state": (None if self.grid_state is None
                           else self.grid_state._asdict()),
            "budgets": (self._cur_grid_K, self._cur_compact_M,
                        self._mean_count_ema),
            "gen": self.gen.get_state(),
            "host_gen": self.host_gen.get_state(),
        }, path)
        with open(os.path.join(self.ckpt_dir, "stats.json"), "w") as f:
            json.dump(self.stats, f)
        if best:
            return path
        ckpts = sorted(d for d in os.listdir(self.ckpt_dir)
                       if d.startswith("step_"))
        for old in ckpts[: -self.cfg.max_keep_ckpt]:
            os.remove(os.path.join(self.ckpt_dir, old))
        return path

    def load_checkpoint(self, which: str = "latest") -> bool:
        """which: latest, best (the best snapshot, else the latest) or a
        path."""
        best = os.path.join(self.ckpt_dir, "best.pt")
        if which == "best" and os.path.exists(best):
            path = best
        elif which in ("latest", "best"):
            ckpts = sorted(d for d in os.listdir(self.ckpt_dir)
                           if d.startswith("step_"))
            if not ckpts:
                return False
            path = os.path.join(self.ckpt_dir, ckpts[-1])
        else:
            path = which
            if not os.path.exists(path):
                return False
        stats = os.path.join(self.ckpt_dir, "stats.json")
        if os.path.exists(stats):
            with open(stats) as f:
                self.stats = json.load(f)
        ck = torch.load(path, map_location=self.device, weights_only=False)
        self.model.load_state_dict(ck["model"])
        if self.ema is not None:
            # a checkpoint without an EMA starts it from its weights
            src = ck.get("ema") or dict(self.model.named_parameters())
            for k, e in self.ema.items():
                e.copy_(src[k])
        self.opt.load_state_dict(ck["optimizer"])
        self.lr_sched.load_state_dict(ck["lr_sched"])
        if ck["grid_state"] is not None:
            self.grid_state = GridState(**{k: v.to(self.device) for k, v
                                           in ck["grid_state"].items()})
        (self._cur_grid_K, self._cur_compact_M,
         self._mean_count_ema) = ck["budgets"]
        self.gen.set_state(ck["gen"].cpu())
        self.host_gen.set_state(ck["host_gen"].cpu())
        self.step = int(ck["step"])
        return True
