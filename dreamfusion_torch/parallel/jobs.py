"""Rank jobs for ``sharding.spawn`` that drive the data-parallel path and
return what each rank saw: the parity tests (tests/test_torch_parallel.py)
and chip_smoke.py's dp phase run them. They live in the package so that the
ranks import the port alone.

Each job takes the rank's ``sharding.DataParallel`` first and returns
tensors on the CPU.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Dict, List, Optional

import torch

from dreamfusion_torch import cameras
from dreamfusion_torch.config import Config, parse_config
from dreamfusion_torch.guidance import none_guidance
from dreamfusion_torch.models.networks import build_model, make_field_fns
from dreamfusion_torch.ops import cuda
from dreamfusion_torch.ops.marching import GridState, render_grid
from dreamfusion_torch.parallel import sharding
from dreamfusion_torch.training import trainer as trainer_mod


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree


def _to(tree, dev):
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree


def _grads(model) -> Dict[str, torch.Tensor]:
    return {k: (p.grad.detach().clone() if p.grad is not None
                else torch.zeros_like(p))
            for k, p in model.named_parameters() if p.requires_grad}


def grads_job(dp: sharding.DataParallel, cfg_kw: Dict[str, Any],
              state: Dict[str, torch.Tensor], grid: GridState,
              draws: List[Dict[str, Any]], text_z: torch.Tensor,
              step: int = 0):
    """One grid-renderer grads_fn on this rank's draws (draws[rank]), then
    the same through data_parallel_grads. Returns the local and the
    averaged gradients and losses."""
    cfg = Config(**cfg_kw)
    dev = dp.device
    model = build_model(cfg, dev)
    model.load_state_dict(state)
    grid = GridState(*(t.to(dev) for t in grid))
    text_z = text_z.to(dev)
    fn = trainer_mod.make_grads_fn(cfg, model, none_guidance(dev))
    mine = _to(draws[dp.rank], dev)
    loss, _ = fn(step, text_z, grid, draws=mine)
    local = _grads(model)
    dp_fn = sharding.data_parallel_grads(fn, model, dp)
    loss_dp, metrics = dp_fn(step, text_z, grid, draws=mine)
    return _cpu({"local": local, "local_loss": loss, "dp": _grads(model),
                 "dp_loss": loss_dp, "metrics": metrics})


def frame_job(dp: sharding.DataParallel, cfg_kw: Dict[str, Any],
              state: Dict[str, torch.Tensor], grid: GridState, frame: int,
              size: int):
    """Orbit frame `frame` of `size` through make_eval_render with the
    group: the ray-sharded render of a grid trainer."""
    cfg = Config(**cfg_kw)
    model = build_model(cfg, dp.device)
    model.load_state_dict(state)
    grid = GridState(*(t.to(dp.device) for t in grid))
    b = cameras.sample_test_batch(frame, size, cfg, device=dp.device)
    render = trainer_mod.make_eval_render(cfg, model, cfg.H, cfg.W, dp)
    return _cpu(render(b["rays_o"][0], b["rays_d"][0], grid))


def _digest(trainer) -> str:
    h = hashlib.sha256()
    for t in list(trainer.model.state_dict().values()) + list(
            trainer.grid_state):
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()


def direct_frame(trainer, frame: int, chunk: int = 4096):
    """Orbit frame `frame` of the trainer's test orbit by a direct full-K
    render_grid in chunks on this process alone (the staged eval's
    oracle)."""
    cfg = trainer.cfg
    b = cameras.sample_test_batch(frame, cfg.test_size, cfg, H=cfg.H,
                                  W=cfg.W, device=trainer.device)
    o, d = b["rays_o"][0], b["rays_d"][0]
    fns = make_field_fns(trainer.model)._replace(normal=None)
    with torch.no_grad():
        parts = [render_grid(
            fns, trainer.grid_state, o[s:s + chunk], d[s:s + chunk],
            bound=cfg.bound, min_near=cfg.min_near, max_steps=cfg.max_steps,
            K=cfg.grid_K, dt_gamma=cfg.dt_gamma, bg_radius=cfg.bg_radius,
            light_d=cameras.safe_normalize(o[0]), perturb=False)
            for s in range(0, o.shape[0], chunk)]
    return {k: torch.cat([p[k] for p in parts]).reshape(
        (cfg.H, cfg.W) + tuple(parts[0][k].shape[1:]))
        for k in ("image", "depth", "weights_sum")}


def train_job(dp: sharding.DataParallel, argv: List[str], steps: int,
              frame: Optional[int] = 1):
    """A Trainer of the group trains `steps` steps from argv. Returns this
    rank's local gradients of the first step and the group's averaged ones,
    a digest of the parameters and the grid after every step, the step
    walls, the all-reduce's time, the kernels' launch counts over the steps
    and, on rank 0 with `frame`, the
    ray-sharded orbit frame (every rank renders its slice) and rank 0's
    direct render_grid of the same pose."""
    cfg = parse_config(argv)
    tr = trainer_mod.Trainer("dp", cfg, use_checkpoint="scratch",
                             parallel=dp)
    captured: Dict[str, torch.Tensor] = {}
    real = sharding.data_parallel_grads

    def capture_first(grads_fn, model, group):
        def local(*a, **kw):
            out = grads_fn(*a, **kw)
            if not captured:
                captured.update(_grads(model))
            return out
        return real(local, model, group)

    sharding.data_parallel_grads = capture_first
    cuda.reset_counts()
    digests, walls = [], []
    averaged = None
    try:
        for s in range(steps):
            if dp.device.type == "cuda":
                torch.cuda.synchronize(dp.device)
            t0 = time.perf_counter()
            tr.train(max_steps=s + 1, log_interval=1,
                     checkpoint_at_end=False)
            if dp.device.type == "cuda":
                torch.cuda.synchronize(dp.device)
            walls.append(time.perf_counter() - t0)
            if s == 0:
                averaged = _grads(tr.model)
            digests.append(_digest(tr))
    finally:
        sharding.data_parallel_grads = real
    out = {"local": captured, "averaged": averaged, "digests": digests,
           "walls": walls, "losses": [float(x) for x in tr.loss_history],
           "allreduce_s": dp.stats["allreduce_s"],
           "wait_s": dp.stats["wait_s"],
           "allreduces": dp.stats["allreduces"],
           "launches": dict(cuda.launch_counts),
           "budgets": (tr._cur_grid_K, tr._cur_compact_M)}
    if frame is not None:
        if dp.device.type == "cuda":
            torch.cuda.synchronize(dp.device)
        t0 = time.perf_counter()
        sharded = tr._render_orbit_frame(frame, cfg.test_size, cfg.H, cfg.W)
        if dp.device.type == "cuda":
            torch.cuda.synchronize(dp.device)
        out["frame_s"] = time.perf_counter() - t0
        if dp.rank == 0:
            out["frame"] = sharded
            out["direct"] = direct_frame(tr, frame)
    return _cpu(out)
