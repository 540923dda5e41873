"""The general runner of DVGO pretraining mixes: the program's
``DVGOTrainer`` on a fine field at the configuration's widths, looping
``DVGOTrainer.step`` over ray batches in the form DVGO's ray loader
yields them (host arrays: rays_d, rays_o, viewdirs, target).

Set-up (counted in setup_s): the field's weights from the seed, the
trainer (its own CPU init is overwritten), the mix's ``feed_batches``
batches of the scene's rays and their ray jitter from the seed
(inputs.ball_rays), the first ``check_steps`` steps (what `correct`
compares) and the warm-up.

After the window the reference (dfref) takes the same weights, batches
and jitter through the same first steps in float32 with TF32 off; each
step's loss, the first gradient (GroupAdam's first moment after one step)
and the change after the check steps are compared by the worst leaf."""

from __future__ import annotations

import gc
from typing import Dict, List, Optional

import numpy as np
import torch

from benchkit import compare, counts, inputs
from benchkit.harness import loop
from benchkit.trace import profiled

UNIT = "pretrain_step"


def _field_kwargs(config: Dict) -> Dict:
    """The fine field's constructor arguments; the world size from the
    box and the voxel count as DVGO's world_size_for computes it."""
    m, box = config["fine_model"], config["scene"]["fine_box"]
    ext = np.array(box[1]) - np.array(box[0])
    voxel = (ext.prod() / m["num_voxels"]) ** (1 / 3)
    world = tuple(int(x) for x in np.maximum((ext / voxel).astype(int), 1))
    return dict(world_size=world, k0_dim=m["k0_dim"], rgbnet_name=m["rgbnet"],
                rgbnet_width=m["rgbnet_width"], rgbnet_depth=m["rgbnet_depth"],
                posbase_pe=m["posbase_pe"], viewbase_pe=m["viewbase_pe"],
                xyz_min=tuple(box[0]), xyz_max=tuple(box[1]),
                alpha_init=m["alpha_init"], stepsize=m["stepsize"],
                fast_color_thres=m["fast_color_thres"])


def _grads(opt_state: Dict, b1: float) -> Dict[str, torch.Tensor]:
    """The first gradient from GroupAdam's first moment after one step."""
    return {k: m / (1.0 - b1) for k, (m, _) in opt_state.items()}


class Run:
    unit = UNIT

    def __init__(self, cell, seed: int, device="cuda"):
        from dreamfusion_torch.models.dvgo import DVGOField
        from dreamfusion_torch.training.dvgo_trainer import (DVGOStageConfig,
                                                             DVGOTrainer)

        self.cell, self.seed = cell, seed
        self.dev = dev = torch.device(device)
        cfg, mix = cell.config, cell.mix
        self.scene, self.stage = cfg["scene"], dict(cfg["fine_train"])
        streams = inputs.seed_streams(seed, dev)
        self.kw = _field_kwargs(cfg)
        self.init_state = self._field_init(streams["field"])

        batch = self.stage.pop("batch_size")
        self.trainer = tr = DVGOTrainer(
            DVGOField(**self.kw), DVGOStageConfig(batch_size=batch,
                                                  **self.stage),
            near=self.scene["near"], far=self.scene["far"],
            bg=(1.0, 1.0, 1.0), device=str(dev))
        tr.field.load_state_dict(self.init_state)
        inputs.note("field weights and trainer")
        self.batches = inputs.ball_rays(self.scene, mix["feed_batches"], batch,
                                        seed)
        self.jitter = torch.rand((mix["feed_batches"], batch, 1),
                                 generator=streams["feed"], device=dev)
        inputs.note("ray batches and jitter")
        self.i = 0
        self.prog_losses: List[float] = []
        for k in range(mix["check_steps"]):
            logs = self._step()
            self.prog_losses.append(float(logs["loss"]))
            if k == 0:
                self.prog_grads = compare.leaf_norms(
                    _grads(tr.opt.state, tr.opt.b1))
        params = dict(tr.field.named_parameters())
        self.prog_change = compare.leaf_norms(
            {k: params[k].detach() - self.init_state[k].to(dev)
             for k in self.init_state if k in params})
        inputs.note("the checked steps")
        while self.i < mix["check_steps"] + mix["warmup_steps"]:
            self._step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        inputs.note("warm-up")

    def _field_init(self, generator) -> Dict[str, torch.Tensor]:
        from dfref.models.dvgo import DVGOField

        ref = DVGOField(**self.kw).to(self.dev)
        ref.reset_parameters(generator)
        # kept on the host, out of the window's peak
        return {k: v.detach().to("cpu", copy=True)
                for k, v in ref.state_dict().items()}

    def _step(self):
        j = self.i % len(self.batches)
        self.i += 1
        return self.trainer.step(self.batches[j], {"jitter": self.jitter[j]})

    # -- the window ------------------------------------------------------------

    def steps(self, n: Optional[int] = None, seconds: Optional[float] = None,
              stamps=None):
        """Steps, n or for `seconds` -> (steps, their losses)."""
        return loop(lambda: self._step()["loss"], n, seconds, stamps)

    @torch.no_grad()
    def _work(self):
        """(operations, bytes) of the next step, from its inputs: the
        samples inside the box and those whose weight passes the field's
        fast_color_thres, found by the reference's sampler and density on
        the program's current grids."""
        from dfref.models.dvgo import DVGOField, cumprod_exclusive, sample_ray

        tr, m = self.trainer, self.cell.config["fine_model"]
        ref = DVGOField(**self.kw).to(self.dev)
        ref.load_state_dict(tr.field.state_dict())
        j = self.i % len(self.batches)
        rays_d, rays_o = (torch.as_tensor(a, device=self.dev)
                          for a in self.batches[j][:2])
        pts, oob = sample_ray(rays_o, rays_d, near=self.scene["near"],
                              far=self.scene["far"], xyz_min=ref.mins,
                              xyz_max=ref.maxs, voxel_size=ref.voxel_size,
                              stepsize=ref.stepsize,
                              n_samples=tr.n_samples, jitter=self.jitter[j])
        alpha = torch.where(oob, 0.0, ref.query_alpha(pts))
        weights = alpha * cumprod_exclusive(1.0 - alpha)[..., :-1]
        n_alive = int((weights > ref.fast_color_thres).sum())
        n_inside = int((~oob).sum())
        nx, ny, nz = ref.world_size
        return counts.dvgo_step_work(
            rays_o.shape[0], n_inside, n_alive, nx * ny * nz, m["k0_dim"],
            ref.rgbnet_in_dim(), m["rgbnet_width"], m["rgbnet_depth"])

    def trace(self):
        work = self._work()
        out = {}

        def stretch():
            out["n"], out["losses"] = self.steps(n=self.cell.mix["trace_steps"])

        summary = profiled(stretch)
        return summary, {"units": out["n"], "losses": out["losses"],
                         "step_work": work}

    def release(self) -> None:
        self.trainer = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        pass

    def program_record(self) -> Dict[str, object]:
        return {"losses": self.prog_losses, "grads": self.prog_grads,
                "change": self.prog_change}

    # -- the reference -----------------------------------------------------------

    def reference(self, precision: str = "f32",
                  fault: Optional[str] = None) -> Dict[str, object]:
        """The first check_steps in plain PyTorch on the same inputs, in
        float32 with TF32 off ("f32"), or with TF32 on ("control", the
        next precision below the configuration's float32). fault
        (calibration only): "half_batch", each step on the first half of
        its rays."""
        from dfref.models.dvgo import DVGOField
        from dfref.steps import GroupAdam, dvgo_step

        dev, mix = self.dev, self.cell.mix
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        tf32 = precision == "control"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            field = DVGOField(**self.kw).to(dev)
            field.load_state_dict(self.init_state)
            opt = GroupAdam(self.stage)
            n_samples = field.n_render_samples(self.scene["far"])
            losses = []
            for k in range(mix["check_steps"]):
                rays_d, rays_o, viewdirs, target = (
                    torch.as_tensor(a, device=dev) for a in self.batches[k])
                jitter = self.jitter[k]
                if fault == "half_batch":
                    h = rays_o.shape[0] // 2
                    rays_d, rays_o, viewdirs, target, jitter = (
                        x[:h] for x in (rays_d, rays_o, viewdirs, target,
                                        jitter))
                losses.append(dvgo_step(
                    field, opt, rays_o, rays_d, viewdirs, target, jitter,
                    near=self.scene["near"], far=self.scene["far"],
                    bg=(1.0, 1.0, 1.0), n_samples=n_samples,
                    stage=self.stage))
                if k == 0:
                    grads = compare.leaf_norms(_grads(opt.state, opt.b1))
            params = dict(field.named_parameters())
            change = compare.leaf_norms(
                {k: params[k].detach() - self.init_state[k].to(dev)
                 for k in grads})
            return {"losses": losses, "grads": grads, "change": change}
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


def readings(prog: Dict[str, object], ref: Dict[str, object]
             ) -> Dict[str, float]:
    """compare.train_readings, the loss gap relative to the reference's
    loss."""
    return compare.train_readings(prog, ref)


leaf_gaps = compare.leaf_gaps
