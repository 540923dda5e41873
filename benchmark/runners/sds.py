"""The general runner of SDS training mixes: the program's ``Trainer``
built on the configuration's field and SD models, and a closed loop of
``Trainer.advance`` as ``Trainer.train`` runs it, without its logging.

Set-up (counted in setup_s): the asset (the field that SDS trains) from
the configuration's ``asset_seed``, the SD weights and the text
embeddings from the run's seed (inputs.py), the Trainer around them, its
generators seeded by the run's seed, the step set to the mix's
``start_step``, the card's allocation peak reset (train_peak_gib reads
the peak from here on), one full occupancy refresh on the seed's jitter,
then the first ``check_steps`` steps and the warm-up to ``warmup_steps``. The
checked steps take their draws from the benchmark (the Trainer's
``train_step`` is handed them), so that the reference can follow them;
every later step, the window's included, draws its own from the
Trainer's generators, as ``Trainer.train`` does.

After the window the program's state is freed, and the plain reference
(dfref) takes the same inputs through the same first steps in float32:
each step's loss, the first gradient (from Adam's first moment after one
step) and the parameters' change after the check steps are compared, by
the worst leaf, as compare.py says."""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
from collections import Counter
from types import SimpleNamespace
from typing import Dict, List, Optional

import torch

from benchkit import cells, compare, counts, inputs, lowp
from benchkit.harness import loop
from benchkit.trace import profiled

UNIT = "sds_step"


def _sd_modules(pkg: str, sd: Dict, device):
    """The SD UNet and VAE of the package `pkg` (the program's
    ``dreamfusion_torch.guidance.sd`` or the reference's ``dfref.sd``)
    at the configuration's widths, built on the device."""
    import importlib

    unet_mod = importlib.import_module(f"{pkg}.unet")
    vae_mod = importlib.import_module(f"{pkg}.vae")
    with torch.device(device):
        unet = unet_mod.UNet2DCondition(**counts.sd_unet_kwargs(sd["unet"]))
        vae = vae_mod.AutoencoderKL(**counts.sd_vae_kwargs(sd["vae"]))
    return unet, vae


def _adam_first_grads(opt, named) -> Dict[str, torch.Tensor]:
    """The first gradient as the optimizer got it: Adam's first moment
    after one step over (1 - beta1)."""
    out = {}
    for group in opt.param_groups:
        b1 = group["betas"][0]
        for p in group["params"]:
            st = opt.state.get(p, {})
            if "exp_avg" in st:
                out[named[id(p)]] = st["exp_avg"] / (1.0 - b1)
    return out


class Run:
    unit = UNIT

    def __init__(self, cell, seed: int, device="cuda"):
        from dreamfusion_torch.config import Config
        from dreamfusion_torch.guidance.sd.sds import freeze, sd_guidance
        from dreamfusion_torch.models.networks import build_model
        from dreamfusion_torch.training.trainer import Trainer

        self.cell, self.seed = cell, seed
        self.dev = dev = torch.device(device)
        mix, sd = cell.mix, cell.config["sd"]
        self.fields = fields = cells.trainer_fields(cell)
        self.conf = conf = Config().replace(**fields).replace(
            seed=inputs.fold(seed))
        streams = inputs.seed_streams(seed, dev)
        asset = inputs.asset_generator(cell.config, dev)
        self.workspace = tempfile.mkdtemp(prefix="bench_sds_")
        self.scene_dir = tempfile.mkdtemp(prefix="bench_scene_")
        if cell.config["field"] == "dvgo":
            # the pretrained scene, a file that both sides read
            fields["pretrained_dvgo"] = os.path.join(self.scene_dir,
                                                     "scene.dvgo")
            inputs.write_dvgo(fields["pretrained_dvgo"],
                              cell.config["edit_scene"], asset, dev)
            self.conf = conf = conf.replace(
                pretrained_dvgo=fields["pretrained_dvgo"])
        # kept on the host, out of the window's peak
        self.init_state = {k: v.detach().to("cpu", copy=True) for k, v in
                           self._ref_field(asset).state_dict()
                           .items()}

        inputs.note("field weights")
        model = build_model(conf, dev)
        model.load_state_dict(self.init_state)
        dtype = getattr(torch, sd["dtype"])
        unet, vae = _sd_modules("dreamfusion_torch.guidance.sd", sd, dev)
        for m, key in ((unet, "unet"), (vae, "vae")):
            n = sum(p.numel() for p in m.parameters())
            if n != sd[key]["n_params"]:
                raise RuntimeError(f"the program's {key} holds {n:,} "
                                   f"parameters, the configuration "
                                   f"{sd[key]['n_params']:,}")
            inputs.fill_lecun(freeze(m, dtype), streams["sd"], dtype)
        guidance = sd_guidance(unet, vae, sd["latent_size"],
                               guidance_scale=conf.guidance_scale)
        inputs.note("SD modules built and filled")
        conf = conf.replace(workspace=self.workspace, ckpt="scratch",
                            text="benchmark", sd_weights="random-full")
        self.trainer = tr = Trainer("bench", conf, model=model,
                                    guidance=guidance, device=str(dev))
        self.text_z = inputs.text_embeddings(
            6 if conf.dir_text else 1, sd["unet"]["cross_attention_dim"],
            streams["text"], dev)
        tr.text_z = self.text_z
        feed = inputs.sds_feed(conf, mix["check_steps"], sd["latent_size"],
                               sd["t_range"], streams["feed"], dev)
        self.check_draws = [inputs.feed_step(feed, i)
                            for i in range(mix["check_steps"])]
        draws = iter(self.check_draws)
        train_step = tr.train_step
        # the checked steps only (the instance attribute shadows the
        # method), each handed a copy: the reference reads them again
        tr.train_step = lambda: train_step(draws={
            k: (v.clone() if torch.is_tensor(v) else v)
            for k, v in next(draws).items()})
        tr.step = mix["start_step"]
        if dev.type == "cuda":
            # train_peak_gib: the peak from the program's first refresh on
            torch.cuda.synchronize(dev)
            self.peak_before_training = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        self.jitter = torch.rand(
            (conf.cascade, conf.grid_size ** 3, 3), generator=streams["grid"],
            device=dev)
        tr.update_grid(0, jitter=self.jitter)
        inputs.note("trainer, draws and the first refresh")

        named = {id(p): k for k, p in tr.model.named_parameters()}
        self.prog_losses: List[float] = []
        self.last = None
        for i in range(mix["check_steps"]):
            self.last = tr.advance(self.last)
            self.prog_losses.append(float(self.last["loss"]))
            if i == 0:
                self.prog_grads = compare.leaf_norms(
                    _adam_first_grads(tr.opt, named))
        params = dict(tr.model.named_parameters())
        self.prog_change = compare.leaf_norms(
            {k: p.detach() - self.init_state[k].to(dev)
             for k, p in params.items() if p.requires_grad})
        del tr.train_step           # the program's own draws from here on
        inputs.note("the checked steps")
        while tr.step < mix["start_step"] + mix["warmup_steps"]:
            self.last = tr.advance(self.last)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        inputs.note("warm-up")

    # -- the inputs the benchmark makes --------------------------------------

    def _ref_field(self, generator=None):
        """The reference's field: the grid field initialised from the
        generator, or the editing field read from the scene file."""
        f = self.fields
        if self.cell.config["field"] == "dvgo":
            from dfref.models.kailu import DVGOEditNetwork

            ref = DVGOEditNetwork.from_config(SimpleNamespace(**f))
            ref.to(self.dev).reset_parameters(generator)
            ref.load_pretrained()
            return ref
        from dfref.models.networks import NeRFGridNetwork

        ref = NeRFGridNetwork(bound=f["bound"], bg_radius=f["bg_radius"]
                              ).to(self.dev)
        ref.reset_parameters(generator)
        return ref

    # -- the window ------------------------------------------------------------

    def steps(self, n: Optional[int] = None, seconds: Optional[float] = None,
              stamps=None):
        """Steps, n or for `seconds` -> (steps, their losses as device
        tensors)."""
        self.budgets = Counter()
        return loop(self._advance, n, seconds, stamps)

    def _advance(self):
        tr = self.trainer
        self.last = tr.advance(self.last)
        self.budgets[(tr._cur_grid_K, tr._cur_compact_M)] += 1
        return self.last["loss"]

    def window_note(self) -> None:
        """The (K, M) sample budgets the window's steps ran at."""
        print("[window] steps by (K, M): " + ", ".join(
            f"{k}: {v}" for k, v in sorted(self.budgets.items(), key=str)),
            file=sys.stderr, flush=True)

    def trace(self):
        """The mix's trace_steps under the profiler -> (Summary, extra)."""
        out = {}

        def stretch():
            out["n"], out["losses"] = self.steps(n=self.cell.mix["trace_steps"])

        summary = profiled(stretch)
        return summary, {"units": out["n"], "losses": out["losses"],
                         "sd_step_flops": counts.sd_step_flops(
                             self.cell.config["sd"]),
                         "sd": self.cell.config["sd"]}

    def release(self) -> None:
        self.trainer = None
        shutil.rmtree(self.workspace, ignore_errors=True)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference -----------------------------------------------------------

    def reference(self, precision: str = "f32",
                  fault: Optional[str] = None) -> Dict[str, object]:
        """The first check_steps in plain PyTorch on the same inputs.
        precision "f32" (the reference) or "control", each part in the
        next precision below the configuration's: SD (bf16) and, where the
        configuration states half precision for the field (fp16, -O), the
        field's MLPs (the grid field's sigma and background nets, the DVGO
        rgbnet) in float8 e4m3 (weights and inputs rounded, one scale a
        tensor); float32 products elsewhere in TF32.
        fault (calibration only): "half_batch", the second half of the
        rays' colours detached and the regularizers' means over the first
        half (dfref.steps.SDSStep)."""
        from dfref.ops.marching import init_grid_state, update_grid
        from dfref.sd import layers as ref_layers
        from dfref.sd.scheduler import make_schedule
        from dfref.sd.unet import LayerNorm
        from dfref.steps import SDSStep

        f, sd, dev = self.fields, self.cell.config["sd"], self.dev
        ns = SimpleNamespace(**f)
        control = precision == "control"
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32, ref_layers.GN_DTYPE)
        torch.backends.cuda.matmul.allow_tf32 = control
        torch.backends.cudnn.allow_tf32 = control
        ref_layers.GN_DTYPE = "bf16" if control else "f32"
        try:
            model = self._ref_field()
            model.load_state_dict(self.init_state)
            if control and f["fp16"]:
                # the field's MLPs: -O states half precision for them
                for mlp in (getattr(model, "sigma_net", None), model.bg_net):
                    if mlp is not None:
                        lowp.fp8_mlp(mlp)
                if f["backbone"] == "dvgo":
                    lowp.fp8_linears(model.main.rgbnet)
            streams = inputs.seed_streams(self.seed, dev)
            unet, vae = _sd_modules("dfref.sd", sd, dev)
            for m in (unet, vae):
                m.requires_grad_(False).eval()
                if control:          # stored in bf16, the norms in f32
                    m.to(torch.bfloat16)
                    for sub in m.modules():
                        if isinstance(sub, (ref_layers.GroupNorm, LayerNorm)):
                            sub.float()
                inputs.fill_lecun(m, streams["sd"], getattr(torch, sd["dtype"]))
                if control:
                    lowp.fp8_module(m)
            grid = update_grid(
                model.density,
                init_grid_state(cells.cascade(f["bound"]), f["grid_size"], dev),
                bound=f["bound"], density_thresh=f["density_thresh"],
                decay=f["grid_decay"], partial=None, jitter=self.jitter)
            step = SDSStep(ns, model, unet, vae, make_schedule(device=dev),
                           self.text_z, sd["latent_size"], fault=fault)
            named = {id(p): k for k, p in model.named_parameters()}
            losses, scales = [], []
            for i, draws in enumerate(self.check_draws):
                losses.append(step.step(self.cell.mix["start_step"] + i, grid,
                                        draws, K=f["grid_K"]))
                scales.append(step.loss_scale)
                if i == 0:
                    grads = compare.leaf_norms(_adam_first_grads(step.opt,
                                                                 named))
            params = dict(model.named_parameters())
            change = compare.leaf_norms(
                {k: params[k].detach() - self.init_state[k].to(dev)
                 for k in grads})
            return {"losses": losses, "scales": scales, "grads": grads,
                    "change": change}
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, ref_layers.GN_DTYPE) = old

    def close(self) -> None:
        """Remove the scene file once no reference needs it."""
        shutil.rmtree(self.scene_dir, ignore_errors=True)

    def program_record(self) -> Dict[str, object]:
        return {"losses": self.prog_losses, "grads": self.prog_grads,
                "change": self.prog_change}


def readings(prog: Dict[str, object], ref: Dict[str, object]
             ) -> Dict[str, float]:
    """compare.train_readings, the loss gap over the SDS term's
    Cauchy-Schwarz bound: the loss is a sum of products of either sign,
    so its own size is no scale."""
    return compare.train_readings(prog, ref, ref["scales"])


leaf_gaps = compare.leaf_gaps

