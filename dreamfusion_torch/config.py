"""Configuration for dreamfusion_torch (counterpart of dreamfusion_tpu/config.py).

The port keeps its own copy, limited to the fields its training paths
(``-O``: the grid or editing field on the occupancy-grid renderer; ``-O2``:
the grid or vanilla field on the stratified renderer) and the eval / 360-
degree test render read. ``-O`` = bf16 compute + occupancy-grid renderer +
view-dependent text (reference main.py:75-79); ``-O2`` = bf16 compute +
view-dependent text, stratified renderer (main.py:81-84). On the GPU
"fp16" means bf16 compute with f32 parameters, as in the JAX package.
``finalize`` applies the backbone's defaults (main.py:86-89).

``gui`` starts the interactive viewer and trainer (apps/gui.py),
``save_mesh`` exports a textured mesh after the test orbit, ``max_spp`` is
the samples a pixel the GUI accumulates while the view stays still, and
``aabb_infer`` (set by the GUI's sliders; None = +-bound) narrows the eval
renderer's ray box, never the train path's.

The train options ``jitter_pose``, ``dt_gamma`` (cone stepping),
``ema_decay`` and ``optimizer`` ("adam" | "shampoo") and the data-parallel
``n_devices`` (0 = every visible card) are the JAX package's. Its
``mesh_shape`` and ``mesh_axes`` are read nowhere there beyond its
config.py, so the port has neither.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from dataclasses import dataclass
from typing import List, Optional, Tuple


@dataclass
class Config:
    # -- experiment ---------------------------------------------------------
    text: Optional[str] = None
    negative: str = ""
    workspace: str = "workspace"
    seed: int = 0
    test: bool = False
    gui: bool = False                   # interactive viewer (apps/gui.py)
    save_mesh: bool = False             # export a textured mesh after test
    eval_interval: int = 10             # eval every N epochs
    guidance: str = "stable-diffusion"  # 'stable-diffusion' | 'clip' | 'none'
    ckpt: str = "latest"                # latest | scratch | <path>
    device: Optional[str] = None        # None = cuda (raises without a GPU)

    # -- training -----------------------------------------------------------
    iters: int = 10000
    lr: float = 1e-3
    batch_size: int = 1
    grid_ray: bool = False
    max_steps: int = 512
    num_steps: int = 64                 # coarse samples/ray (stratified)
    upsample_steps: int = 64            # importance samples/ray (stratified)
    update_extra_interval: int = 16
    albedo_iters: int = 1000
    uniform_sphere_rate: float = 0.5
    grid_K: int = 128
    grid_K_adaptive: bool = True
    grid_size: int = 128
    grid_compact: bool = True
    grid_compact_slack: float = 1.25
    grid_decay: float = 0.95
    max_ray_batch: int = 4096           # rays per staged-eval group
    # the staged eval's bf16 table view for the corner gathers (the
    # reference evals under fp16 autocast; parameters stay f32)
    eval_table_bf16: bool = True
    # eval-only ray box (xmin, ymin, zmin, xmax, ymax, zmax); None = +-bound
    # (the reference's GUI sliders, nerf/gui.py:319-345)
    aabb_infer: Optional[Tuple[float, ...]] = None
    max_spp: int = 1                    # GUI samples a pixel when still

    # -- model ---------------------------------------------------------------
    backbone: str = "grid"              # 'grid' | 'vanilla' | 'dvgo'
    bg_radius: float = 1.4
    density_thresh: float = 10.0
    fp16: bool = True                   # bf16 compute, f32 params
    # editing mode: path of a pretrained DVGO checkpoint (backbone "dvgo");
    # its geometry is frozen and only the colour MLP trains
    pretrained_dvgo: Optional[str] = None

    # -- render resolution ----------------------------------------------------
    w: int = 64
    h: int = 64
    W: int = 800                        # eval/test render width
    H: int = 800                        # eval/test render height
    jitter_pose: bool = False

    # -- scene ---------------------------------------------------------------
    bound: float = 1.0
    dt_gamma: float = 0.0               # > 0: cone stepping (kernel F)
    min_near: float = 0.1
    radius_range: Tuple[float, float] = (1.0, 1.5)
    fovy_range: Tuple[float, float] = (40.0, 70.0)
    dir_text: bool = False
    suppress_face: bool = False
    angle_overhead: float = 30.0
    angle_front: float = 60.0

    # -- losses ---------------------------------------------------------------
    lambda_entropy: float = 1e-4
    lambda_opacity: float = 0.0
    lambda_orient: float = 1e-2
    lambda_smooth: float = 0.0

    # -- guidance -------------------------------------------------------------
    guidance_scale: float = 100.0
    # an SD v1.5 dir | random-full (SD v1.5) | random-xl (SDXL base 1.0)
    # | random-tiny / -nano / -xl-tiny (CPU sizes)
    sd_weights: Optional[str] = None
    clip_weights: Optional[str] = None  # random-tiny (the one buildable)

    # -- optimizer --------------------------------------------------------------
    optimizer: str = "adam"             # 'adam' | 'shampoo'
    adam_b1: float = 0.9
    adam_b2: float = 0.99
    adam_eps: float = 1e-15
    ema_decay: Optional[float] = None

    # -- bookkeeping ------------------------------------------------------------
    dataset_size: int = 100             # steps per "epoch"
    test_size: int = 100                # frames in the 360-degree test orbit
    val_size: int = 5                   # frames of each evaluation
    max_keep_ckpt: int = 2

    # -- parallelism --------------------------------------------------------------
    # data-parallel ranks, one process and one card each (1 = one process,
    # 0 = every visible card); the camera batch is per rank, as with DDP
    # (nerf/utils.py:200-202)
    n_devices: int = 1

    @property
    def cascade(self) -> int:
        return 1 + math.ceil(math.log2(max(self.bound, 1.0)))

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def presets_O(cfg: "Config") -> "Config":
        """-O: bf16 + occupancy-grid marching + dir text (main.py:75-79)."""
        return cfg.replace(fp16=True, dir_text=True, grid_ray=True)

    @staticmethod
    def presets_O2(cfg: "Config") -> "Config":
        """-O2: bf16 + dir text, stratified renderer (main.py:81-84)."""
        return cfg.replace(fp16=True, dir_text=True)

    def finalize(self) -> "Config":
        """Backbone-conditional defaults (main.py:86-89)."""
        if self.backbone == "vanilla":
            return self.replace(lambda_entropy=0.0, lambda_opacity=1e-3)
        return self


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("dreamfusion_torch")
    d = Config()
    p.add_argument("--text", default=None)
    p.add_argument("--negative", default="", type=str)
    p.add_argument("-O", action="store_true",
                   help="preset: bf16 + grid_ray + dir_text")
    p.add_argument("-O2", action="store_true",
                   help="preset: bf16 + dir_text (stratified renderer)")
    p.add_argument("--test", action="store_true")
    p.add_argument("--save_mesh", action="store_true")
    p.add_argument("--gui", action="store_true")
    p.add_argument("--max_spp", type=int, default=d.max_spp)
    p.add_argument("--device", default=None, choices=["cuda", "cpu"],
                   help="default cuda; cpu runs the plain PyTorch path")
    p.add_argument("--eval_interval", type=int, default=d.eval_interval)
    p.add_argument("--workspace", type=str, default=d.workspace)
    p.add_argument("--guidance", type=str, default=d.guidance)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--iters", type=int, default=d.iters)
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--ckpt", type=str, default=d.ckpt)
    p.add_argument("--grid_ray", "--cuda_ray", dest="grid_ray",
                   action="store_true")
    p.add_argument("--max_steps", type=int, default=d.max_steps)
    p.add_argument("--num_steps", type=int, default=d.num_steps)
    p.add_argument("--upsample_steps", type=int, default=d.upsample_steps)
    p.add_argument("--update_extra_interval", type=int,
                   default=d.update_extra_interval)
    p.add_argument("--albedo_iters", type=int, default=d.albedo_iters)
    p.add_argument("--uniform_sphere_rate", type=float,
                   default=d.uniform_sphere_rate)
    p.add_argument("--grid_K", type=int, default=d.grid_K)
    p.add_argument("--no_grid_K_adaptive", dest="grid_K_adaptive",
                   action="store_false", default=d.grid_K_adaptive)
    p.add_argument("--grid_size", type=int, default=d.grid_size)
    p.add_argument("--no_grid_compact", dest="grid_compact",
                   action="store_false", default=d.grid_compact)
    p.add_argument("--grid_compact_slack", type=float,
                   default=d.grid_compact_slack)
    p.add_argument("--grid_decay", type=float, default=d.grid_decay)
    p.add_argument("--max_ray_batch", type=int, default=d.max_ray_batch)
    p.add_argument("--no_eval_table_bf16", dest="eval_table_bf16",
                   action="store_false", default=d.eval_table_bf16)
    p.add_argument("--dataset_size", type=int, default=d.dataset_size)
    p.add_argument("--ema_decay", type=float, default=None)
    p.add_argument("--optimizer", type=str, default=d.optimizer)
    p.add_argument("--n_devices", type=int, default=d.n_devices,
                   help="data-parallel ranks, one card each (0 = all "
                        "visible); with --device cpu, gloo ranks on the CPU")
    p.add_argument("--max_keep_ckpt", type=int, default=d.max_keep_ckpt)
    p.add_argument("--test_size", type=int, default=d.test_size)
    p.add_argument("--val_size", type=int, default=d.val_size)
    p.add_argument("--backbone", type=str, default=d.backbone)
    p.add_argument("--pretrained_dvgo", type=str, default=None)
    p.add_argument("--bg_radius", type=float, default=d.bg_radius)
    p.add_argument("--density_thresh", type=float, default=d.density_thresh)
    p.add_argument("--fp16", action="store_true")
    p.add_argument("--sd_weights", type=str, default=None)
    p.add_argument("--clip_weights", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=d.batch_size)
    p.add_argument("--w", type=int, default=d.w)
    p.add_argument("--h", type=int, default=d.h)
    p.add_argument("--jitter_pose", action="store_true")
    p.add_argument("--W", type=int, default=d.W)
    p.add_argument("--H", type=int, default=d.H)
    p.add_argument("--bound", type=float, default=d.bound)
    p.add_argument("--dt_gamma", type=float, default=d.dt_gamma)
    p.add_argument("--min_near", type=float, default=d.min_near)
    p.add_argument("--radius_range", type=float, nargs="*",
                   default=list(d.radius_range))
    p.add_argument("--fovy_range", type=float, nargs="*",
                   default=list(d.fovy_range))
    p.add_argument("--dir_text", action="store_true")
    p.add_argument("--suppress_face", action="store_true")
    p.add_argument("--angle_overhead", type=float, default=d.angle_overhead)
    p.add_argument("--angle_front", type=float, default=d.angle_front)
    p.add_argument("--lambda_entropy", type=float, default=d.lambda_entropy)
    p.add_argument("--lambda_opacity", type=float, default=d.lambda_opacity)
    p.add_argument("--lambda_orient", type=float, default=d.lambda_orient)
    p.add_argument("--lambda_smooth", type=float, default=d.lambda_smooth)
    p.add_argument("--guidance_scale", type=float, default=d.guidance_scale)
    return p


def parse_config(argv: Optional[List[str]] = None) -> Config:
    ns = build_argparser().parse_args(argv)
    names = {f.name for f in dataclasses.fields(Config)}
    kw = {}
    for k, v in vars(ns).items():
        if k in names:
            kw[k] = tuple(v) if k in ("radius_range", "fovy_range") else v
    cfg = Config(**kw)
    if ns.O:
        cfg = Config.presets_O(cfg)
    elif ns.O2:
        cfg = Config.presets_O2(cfg)
    return cfg.finalize()
