"""DVGO pretraining (pipeline 3): coarse -> fine voxel-grid training
(counterpart of dreamfusion_tpu/training/dvgo_trainer.py).

Rebuilds the reference's lightning-based stack as a plain PyTorch loop:
- frameworks/nerf/train_nerf_models.py: the coarse box from the camera
  frusta, the fine box from the coarse geometry;
- frameworks/nerf/modules/lightning_base.py: the per-group optimizer and
  the PSNR metric;
- frameworks/nerf/utils.py Adam.set_pervoxel_lr: per-voxel factors from
  view counts, which multiply the Adam *update* (the JAX package's
  ``scale_update_by_factors`` after optax's Adam), not the gradient;
- progressive grid scaling at the pg_scale iterations (dvgo_coarse.py:
  150-188): trilinear re-interpolation and a new optimizer without the
  per-voxel factors, its state reset.

The optimizer is written out (``GroupAdam``): optax's Adam (0.9, 0.999,
1e-8) per group, each group's LR base * 0.1 ** (count / (lrate_decay *
1000)) read at the 0-based count, and a group whose LR is <= 0 frozen with
no state (optax ``set_to_zero``). torch.optim.Adam cannot scale the update
per voxel.

Checkpoints are torch.save files in the lightning state_dict layout, the
file the JAX package writes: the editing field (models/kailu.py) and the
JAX package's ``peek_dvgo_checkpoint`` / ``load_dvgo_state_into_params``
read them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from dreamfusion_torch.device import resolve_device
from dreamfusion_torch.models.dvgo import (DVGOField, dvgo_losses,
                                           sample_ray, scale_volume_grid,
                                           total_variation)
from dreamfusion_torch.ops.grid_sample import grid_sample_3d

_RAY_KEYS = ("ndc", "inverse_y", "flip_x", "flip_y", "mode", "img_type")


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    mse = ((pred - target) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def _view_rays(data_dict: Dict, cfg_data: Dict, i: int):
    from dreamfusion_torch.datasets.rays import get_rays_of_a_view

    H, W = int(data_dict["HW"][i][0]), int(data_dict["HW"][i][1])
    return get_rays_of_a_view(H, W, data_dict["Ks"][i], data_dict["poses"][i],
                              **{k: v for k, v in cfg_data.items()
                                 if k in _RAY_KEYS})


def compute_bbox_by_cam_frustrm(data_dict: Dict, cfg_data: Dict) -> Tuple:
    """Tight box over all train-view frusta at [near, far]
    (modules/utils.py:83-97)."""
    near, far = data_dict["near"], data_dict["far"]
    lo = np.full(3, np.inf)
    hi = -lo
    for i in np.asarray(data_dict["i_train"]):
        ro, rd, vd = _view_rays(data_dict, cfg_data, i)
        pts = np.stack([ro + vd * near, ro + vd * far])
        lo = np.minimum(lo, pts.reshape(-1, 3).min(0))
        hi = np.maximum(hi, pts.reshape(-1, 3).max(0))
    return tuple(lo.tolist()), tuple(hi.tolist())


@torch.no_grad()
def compute_bbox_by_coarse_geo(field: DVGOField, thres: float) -> Tuple:
    """Box of the coarse cells whose alpha exceeds thres
    (modules/utils.py:100-116)."""
    lin = [np.linspace(0, 1, s) for s in field.world_size]
    grid = np.stack(np.meshgrid(*lin, indexing="ij"), -1).reshape(-1, 3)
    interp = torch.as_tensor(grid, dtype=torch.float32,
                             device=field.density.device)
    xyz = field.mins * (1 - interp) + field.maxs * interp
    alpha = field.activate_density(field.sample_density(xyz))
    active = xyz[alpha > thres].cpu().numpy()
    assert active.size > 0, "no active cells above threshold"
    return tuple(active.min(0).tolist()), tuple(active.max(0).tolist())


def world_size_for(xyz_min, xyz_max, num_voxels: int) -> Tuple[int, int, int]:
    """(dvgo_coarse.py:54-66)"""
    ext = np.array(xyz_max) - np.array(xyz_min)
    voxel_size = (ext.prod() / num_voxels) ** (1 / 3)
    ws = np.maximum((ext / voxel_size).astype(int), 1)
    return tuple(int(x) for x in ws)


@dataclass
class DVGOStageConfig:
    """One training stage (coarse_train / fine_train in the mmcv configs)."""
    n_iters: int = 5000
    lr_density: float = 1e-1
    lr_k0: float = 1e-1
    lr_rgbnet: float = 1e-3
    lrate_decay: int = 20            # exp decay to 0.1 over decay*1000 steps
    batch_size: int = 8192
    weight_main: float = 1.0
    weight_entropy_last: float = 0.01
    weight_rgbper: float = 0.1
    entropy_weight: float = 0.0
    weight_tv_density: float = 0.0
    weight_tv_k0: float = 0.0
    pg_scale: Tuple[int, ...] = ()   # iterations at which to double voxels


def _group(name: str) -> str:
    """The JAX package's labels: density, k0, and the rest (rgbnet)."""
    parts = name.split(".")
    if "density" in parts:
        return "density"
    if "k0" in parts:
        return "k0"
    return "rgbnet"


class GroupAdam:
    """Per-group Adam with exponential LR decay and optional per-voxel
    update factors (create_optimizer_or_freeze_model,
    frameworks/nerf/utils.py:166-190; the JAX package's _make_optimizer)."""

    def __init__(self, stage: DVGOStageConfig,
                 pervoxel_factors: Optional[Dict[str, torch.Tensor]] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.base = {"density": stage.lr_density, "k0": stage.lr_k0,
                     "rgbnet": stage.lr_rgbnet}
        self.decay_steps = stage.lrate_decay * 1000
        self.factors = pervoxel_factors or {}
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.state: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def lr(self, group: str, count: int) -> float:
        return self.base[group] * 0.1 ** (count / self.decay_steps)

    @torch.no_grad()
    def step(self, module: torch.nn.Module) -> None:
        count = self.count
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for name, p in module.named_parameters():
            group = _group(name)
            if self.base[group] <= 0 or p.grad is None:
                continue          # set_to_zero: frozen, no state
            g = p.grad
            m, v = self.state.get(name, (torch.zeros_like(p),
                                         torch.zeros_like(p)))
            m = (1 - self.b1) * g + self.b1 * m
            v = (1 - self.b2) * (g * g) + self.b2 * v
            self.state[name] = (m, v)
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            u = -self.lr(group, count) * u
            f = self.factors.get(name)
            if f is not None:
                u = u * f
            p.add_(u)


class DVGOTrainer:
    """Train one DVGO field on a ray dataset (one lightning 'fit' analog).

    The field's parameters are initialised here from `seed` (density and
    k0 ~ N(0, 1), the rgbnet as flax initialises it), on the CPU and then
    moved to `device` (default the GPU; the CPU only when asked). Each
    step draws its ray jitter [N, 1] (and its density noise [N, S] when
    the field has density_noise > 0) from a generator on the device, unless
    the caller passes them (``step`` / ``fit``'s ``draws``)."""

    def __init__(self, field: DVGOField, stage: DVGOStageConfig, *,
                 near: float, far: float, bg=(1.0, 1.0, 1.0), seed: int = 0,
                 pervoxel_factors: Optional[Dict[str, torch.Tensor]] = None,
                 device=None):
        self.device = resolve_device(device)
        self.field = field
        self.stage = stage
        self.near, self.far = near, far
        self.bg = torch.as_tensor(bg, dtype=torch.float32, device=self.device)
        field.cpu().reset_parameters(torch.Generator().manual_seed(seed))
        field.to(self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.n_samples = field.n_render_samples(far)
        self.pervoxel_factors = pervoxel_factors
        self.opt = GroupAdam(stage, pervoxel_factors)
        self.global_step = 0

    def _draws(self, n_rays: int, draws: Optional[Dict]) -> Dict:
        draws = dict(draws or {})
        if draws.get("jitter") is None:
            draws["jitter"] = torch.rand(n_rays, 1, generator=self.generator,
                                         device=self.device)
        if self.field.density_noise > 0 and draws.get("noise") is None:
            draws["noise"] = torch.randn(n_rays, self.n_samples,
                                         generator=self.generator,
                                         device=self.device)
        return {k: (None if v is None else torch.as_tensor(v).to(self.device))
                for k, v in draws.items()}

    def _batch(self, batch):
        return tuple(torch.as_tensor(np.asarray(b), dtype=torch.float32)
                     .to(self.device) for b in batch)

    def step(self, batch, draws: Optional[Dict] = None
             ) -> Dict[str, torch.Tensor]:
        """One training step on (rays_d, rays_o, viewdirs, target).
        Returns the logs (detached tensors; per_ray_err [N] among them)."""
        field, stage = self.field, self.stage
        rays_d, rays_o, viewdirs, target = self._batch(batch)
        d = self._draws(rays_o.shape[0], draws)
        out = field.render(rays_o, rays_d, viewdirs, near=self.near,
                           far=self.far, bg=self.bg, n_samples=self.n_samples,
                           jitter=d["jitter"], noise=d.get("noise"))
        loss, logs = dvgo_losses(
            out, target, weight_main=stage.weight_main,
            weight_entropy_last=stage.weight_entropy_last,
            weight_rgbper=stage.weight_rgbper,
            entropy_weight=stage.entropy_weight)
        if stage.weight_tv_density > 0:
            loss = loss + stage.weight_tv_density * total_variation(
                field.activate_density(field.density))
        if stage.weight_tv_k0 > 0:
            loss = loss + stage.weight_tv_k0 * total_variation(field.k0)
        field.zero_grad(set_to_none=True)
        loss.backward()
        self.opt.step(field)
        with torch.no_grad():
            logs = {k: v.detach() for k, v in logs.items()}
            logs["psnr"] = psnr(out["rgb_marched"], target)
            # per-ray squared error for error-map samplers (nerf/utils.py:73-83)
            logs["per_ray_err"] = ((out["rgb_marched"] - target[..., :3]) ** 2
                                   ).mean(-1)
            logs["loss"] = loss.detach()
        return logs

    def maybe_pg_scale(self, it: int, num_voxels_base: int):
        """Progressive voxel scaling (dvgo_coarse.py:150-188): at each
        pg_scale milestone the voxel count doubles (cumulatively)."""
        if it not in self.stage.pg_scale:
            return
        factor = 2 ** (list(self.stage.pg_scale).index(it) + 1)
        new_ws = world_size_for(self.field.xyz_min, self.field.xyz_max,
                                num_voxels_base * factor)
        scale_volume_grid(self.field, new_ws)
        self.n_samples = self.field.n_render_samples(self.far)
        self.opt = GroupAdam(self.stage, None)

    def fit(self, train_loader, num_voxels_base: Optional[int] = None,
            log_every: int = 500, log_fn: Optional[Callable] = None,
            draws: Optional[Callable[[int], Dict]] = None):
        """Train stage.n_iters steps over the loader's batches (cycling).
        draws (optional): it -> the step's draws (see ``step``)."""
        it = 0
        while it < self.stage.n_iters:
            for batch in train_loader:
                if it >= self.stage.n_iters:
                    break
                if num_voxels_base:
                    self.maybe_pg_scale(it, num_voxels_base)
                logs = self.step(batch, draws(it) if draws else None)
                per_ray_err = logs.pop("per_ray_err")
                if hasattr(train_loader, "update_last"):
                    train_loader.update_last(per_ray_err.cpu().numpy())
                if log_fn and (it % log_every == 0
                               or it == self.stage.n_iters - 1):
                    log_fn(it, {k: float(v) for k, v in logs.items()})
                it += 1
        self.global_step = it
        return self.field

    @torch.no_grad()
    def evaluate(self, loader, max_batches: Optional[int] = None) -> float:
        """Mean PSNR over a ray loader (validation/psnr analog); the render
        draws nothing."""
        total, n = 0.0, 0
        for i, batch in enumerate(loader):
            if max_batches and i >= max_batches:
                break
            rays_d, rays_o, viewdirs, target = self._batch(batch)
            pred = self.field.render(
                rays_o, rays_d, viewdirs, near=self.near, far=self.far,
                bg=self.bg, n_samples=self.n_samples)["rgb_marched"]
            total += float(psnr(pred, target))
            n += 1
        return total / max(n, 1)

    # -- checkpoint interop (.dvgo lightning layout) ---------------------------

    def save_dvgo(self, path: str, cfg_dict: Optional[Dict] = None) -> str:
        f = self.field
        state = {
            "density": f.density.detach().cpu().float().clone()[None],
            "k0": f.k0.detach().cpu().float().clone()[None],
            "xyz_min": torch.tensor(list(f.xyz_min), dtype=torch.float32),
            "xyz_max": torch.tensor(list(f.xyz_max), dtype=torch.float32),
            "voxel_size_ratio": torch.tensor(float(f.voxel_size_ratio)),
            "world_size": torch.tensor(list(f.world_size)),
        }
        if f.rgbnet is not None:
            _export_rgbnet(state, f.rgbnet)
        ckpt = {"state_dict": state,
                "hyper_parameters": {"params": {"cfg": cfg_dict or {
                    "fine_model_and_render": {
                        "rgbnet": f.rgbnet_name or "resmlp",
                        "rgbnet_width": f.rgbnet_width,
                        "rgbnet_depth": f.rgbnet_depth,
                        "posbase_pe": f.posbase_pe,
                        "viewbase_pe": f.viewbase_pe,
                        "alpha_init": f.alpha_init,
                        "stepsize": f.stepsize,
                    }}}}}
        torch.save(ckpt, path)
        return path


def _export_rgbnet(state: Dict, rgbnet: torch.nn.Module) -> None:
    """Inverse of models/kailu.load_dvgo_state for ResMLP / BasicMLP: the
    port's flax-named Linears -> the reference's Sequential indices
    (ResMLP: net.0, net.{2+i}.net, net.{2+n_res}; BasicMLP: dense_i at
    2 i, dense_out after them)."""
    def put(key, lin):
        state[f"rgbnet.net.{key}.weight"] = lin.weight.detach().cpu().clone()
        state[f"rgbnet.net.{key}.bias"] = lin.bias.detach().cpu().clone()

    if hasattr(rgbnet, "dense_in"):
        put(0, rgbnet.dense_in)
        n_res = rgbnet.depth - 2
        for i in range(n_res):
            put(f"{2 + i}.net", getattr(rgbnet, f"res_{i}").net)
        put(2 + n_res, rgbnet.dense_out)
    else:
        hidden = rgbnet.depth - 1
        for i in range(hidden):
            put(2 * i, getattr(rgbnet, f"dense_{i}"))
        put(2 * hidden, rgbnet.dense_out)


def voxel_count_views(field: DVGOField, data_dict: Dict, cfg_data: Dict,
                      stepsize: float, downrate: int = 1,
                      chunk: int = 65536) -> torch.Tensor:
    """Per-voxel view-coverage count driving the per-voxel LR
    (dvgo_coarse.py:104-148): for each train view, march its rays and count
    the grid touches through the gradient of the sum of sampled ones with
    respect to a ones-grid (the reference's autodiff trick); a voxel gains
    2 for each view whose touch exceeds 2. Rays go through in chunks (the
    gradient of a sum is the sum of the chunks' gradients). Returns [1, X,
    Y, Z] float32 on the field's device."""
    dev = field.density.device
    count = torch.zeros((1,) + tuple(field.world_size), device=dev)
    n_samples = field.n_render_samples(data_dict["far"])
    for i in np.asarray(data_dict["i_train"]):
        ro, rd, _ = _view_rays(data_dict, cfg_data, i)
        ro = torch.as_tensor(np.ascontiguousarray(
            ro[::downrate, ::downrate]).reshape(-1, 3), device=dev)
        rd = torch.as_tensor(np.ascontiguousarray(
            rd[::downrate, ::downrate]).reshape(-1, 3), device=dev)
        ones = torch.ones_like(count, requires_grad=True)
        for s in range(0, ro.shape[0], chunk):
            pts, oob = sample_ray(
                ro[s:s + chunk], rd[s:s + chunk], near=data_dict["near"],
                far=data_dict["far"], xyz_min=field.mins, xyz_max=field.maxs,
                voxel_size=field.voxel_size, stepsize=stepsize,
                n_samples=n_samples)
            x01 = (pts - field.mins) / (field.maxs - field.mins)
            vals = grid_sample_3d(ones, torch.clamp(x01.reshape(-1, 3), 0, 1))
            torch.where(oob.reshape(-1, 1), 0.0, vals).sum().backward()
        count += (ones.grad > 2).float() * 2
    return count
