"""The general runner of orbit mixes: ``Trainer.test``'s 360-degree orbit,
frame by frame, each rendered by ``Trainer._render_orbit_frame`` (the
staged grid eval) and written as ``Trainer.test`` writes it
(``Trainer._save_frame``: an 8-bit PNG), the mix's ``orbit`` views taken
in order and cycled.

Set-up (counted in setup_s): the Trainer with no guidance around the
configuration's asset (the field from its ``asset_seed``, the same for
every run), one full occupancy refresh on the seed's jitter, and
``warmup_frames`` frames. The orbit starts at a view drawn from the
seed: every seed renders the same frames, in another order.

`correct`: frames drawn from the seed among those the window wrote are
rendered again by the plain reference (dfref: the field in float32, its
own occupancy grid from the same jitter, a direct full-K ``render_grid`` in
groups of rays, albedo, the background net), quantised as the PNG is, and
compared level by level: the mean and the largest gap over the frame."""

from __future__ import annotations

import gc
import os
import shutil
import tempfile
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from benchkit import cells, inputs, lowp
from benchkit.harness import loop
from benchkit.trace import profiled

UNIT = "frame"


class Run:
    unit = UNIT

    def __init__(self, cell, seed: int, device="cuda"):
        from dreamfusion_torch.config import Config
        from dreamfusion_torch.models.networks import build_model
        from dreamfusion_torch.training.trainer import Trainer

        self.cell, self.seed = cell, seed
        self.dev = dev = torch.device(device)
        mix = cell.mix
        self.fields = cells.trainer_fields(cell)
        streams = inputs.seed_streams(seed, dev)
        self.init_state = {k: v.detach().to("cpu", copy=True) for k, v in
                           self._ref_field(inputs.asset_generator(
                               cell.config, dev)).state_dict().items()}
        self.first_view = int(np.random.RandomState(
            inputs.fold(seed) % (2 ** 32)).randint(mix["orbit"]))
        self.workspace = tempfile.mkdtemp(prefix="bench_orbit_")
        conf = Config().replace(**self.fields).replace(
            guidance="none", workspace=self.workspace, ckpt="scratch")
        model = build_model(conf, dev)
        model.load_state_dict(self.init_state)
        self.trainer = tr = Trainer("bench", conf, model=model,
                                    device=str(dev))
        self.jitter = torch.rand(
            (conf.cascade, conf.grid_size ** 3, 3), generator=streams["grid"],
            device=dev)
        tr.update_grid(0, jitter=self.jitter)
        inputs.note("field weights, trainer and the first refresh")
        self.frames: Dict[int, np.ndarray] = {}
        self.calibration_units = mix["check_frames"]
        self.i = 0
        for _ in range(mix["warmup_frames"]):
            self._frame(keep=False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        inputs.note("warm-up")

    def _ref_field(self, generator=None):
        from dfref.models.networks import NeRFGridNetwork

        f = self.fields
        ref = NeRFGridNetwork(bound=f["bound"], bg_radius=f["bg_radius"]
                              ).to(self.dev)
        ref.reset_parameters(generator)
        return ref

    def _frame(self, keep: bool = True):
        tr, mix = self.trainer, self.cell.mix
        view = (self.first_view + self.i) % mix["orbit"]
        out = tr._render_orbit_frame(view, mix["orbit"], tr.cfg.H, tr.cfg.W)
        rgb = tr._save_frame(out, os.path.join(self.workspace,
                                                f"bench_{view:04d}_rgb.png"))
        if keep:
            self.frames[self.i] = rgb
        self.i += 1
        return out["image"].mean()

    # -- the window ------------------------------------------------------------

    def steps(self, n: Optional[int] = None, seconds: Optional[float] = None,
              stamps=None):
        """Frames, n or for `seconds` -> (frames, their mean colours)."""
        return loop(self._frame, n, seconds, stamps)

    def trace(self):
        out = {}

        def stretch():
            out["n"], out["means"] = self.steps(n=self.cell.mix["trace_frames"])

        summary = profiled(stretch)
        return summary, {"units": out["n"], "losses": out["means"]}

    def release(self) -> None:
        self.trainer = None
        shutil.rmtree(self.workspace, ignore_errors=True)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        pass

    def sample(self) -> List[int]:
        """The frames compared: mix["check_frames"] of those written,
        drawn from the seed."""
        done = sorted(self.frames)
        rng = np.random.RandomState(int(self.seed) % (2 ** 32))
        k = min(self.cell.mix["check_frames"], len(done))
        return sorted(int(x) for x in rng.choice(done, k, replace=False))

    def program_record(self) -> Dict[str, object]:
        return {"frames": {i: self.frames[i] for i in self.sample()}}

    # -- the reference -----------------------------------------------------------

    @torch.no_grad()
    def reference(self, precision: str = "f32",
                  fault: Optional[str] = None) -> Dict[str, object]:
        """The sampled frames rendered by the plain reference in float32
        with TF32 off ("f32"), or computed in float8 e4m3, the next
        precision below the configuration's bf16 table view and bf16 MLPs
        ("control": the table rounded once, each MLP layer's weight and
        input rounded, one scale a tensor). fault (calibration only):
        "altered", each frame's first row of pixels inverted."""
        from dfref import cameras
        from dfref.models.networks import SHADING_ALBEDO, make_field_fns
        from dfref.ops.marching import (init_grid_state, render_grid,
                                        update_grid)

        f, dev, mix = self.fields, self.dev, self.cell.mix
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            model = self._ref_field()
            model.load_state_dict(self.init_state)
            grid = update_grid(
                model.density,
                init_grid_state(cells.cascade(f["bound"]), f["grid_size"],
                                dev),
                bound=f["bound"], density_thresh=f["density_thresh"],
                decay=f["grid_decay"], partial=None, jitter=self.jitter)
            if precision == "control":
                lowp.fp8_field(model)
            fns = make_field_fns(model)
            ns = SimpleNamespace(**f)
            frames = {}
            for i in self.sample():
                view = (self.first_view + i) % mix["orbit"]
                b = cameras.sample_test_batch(view, mix["orbit"], ns,
                                              H=f["H"], W=f["W"], device=dev)
                o, d = b["rays_o"][0], b["rays_d"][0]
                light_d = cameras.safe_normalize(o[0])
                parts = []
                for s in range(0, o.shape[0], f["max_ray_batch"]):
                    out = render_grid(
                        fns, grid, o[s:s + f["max_ray_batch"]],
                        d[s:s + f["max_ray_batch"]], bound=f["bound"],
                        min_near=f["min_near"], max_steps=f["max_steps"],
                        K=f["grid_K"], bg_radius=f["bg_radius"],
                        light_d=light_d, ambient_ratio=1.0,
                        shading_code=SHADING_ALBEDO, perturb=False)
                    parts.append(out["image"])
                img = torch.cat(parts).reshape(f["H"], f["W"], 3)
                rgb = (img.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
                if fault == "altered":
                    rgb = rgb.copy()
                    rgb[0] = 255 - rgb[0]
                frames[i] = rgb
            return {"frames": frames}
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


def readings(prog: Dict[str, object], ref: Dict[str, object]
             ) -> Dict[str, float]:
    """The mean and the largest gap in 8-bit levels between the program's
    written frames and the reference's, the worst frame of each."""
    mean = big = 0.0
    for i, r in ref["frames"].items():
        gap = np.abs(prog["frames"][i].astype(np.int16) - r.astype(np.int16))
        mean = max(mean, float(gap.mean()))
        big = max(big, float(gap.max()))
    return {"frame_mean_gap": mean, "frame_max_gap": big}
