"""dreamfusion_torch CLI: train one text-to-3D asset on the GPU, then render
its 360-degree orbit.

  python -m dreamfusion_torch.main -O --text "a hamburger" --iters 5000
  python -m dreamfusion_torch.main -O --text "a hamburger" --test
  python -m dreamfusion_torch.main -O2 --text "a hamburger"
  python -m dreamfusion_torch.main -O2 --backbone vanilla --guidance clip \
      --clip_weights random-tiny --text "a hamburger"
  python -m dreamfusion_torch.main -O --backbone dvgo \
      --pretrained_dvgo scene.dvgo --bg_radius 0 --text "a golden ficus"
  python -m dreamfusion_torch.main -O --text "a hamburger" \
      --dt_gamma 0.0078125 --jitter_pose --ema_decay 0.95
  python -m dreamfusion_torch.main -O --text "a hamburger" --optimizer shampoo
  python -m dreamfusion_torch.main -O --text "a hamburger" --n_devices 2
  python -m dreamfusion_torch.main -O --text "a hamburger" --test --save_mesh
  python -m dreamfusion_torch.main -O --text "a hamburger" --gui

``-O`` trains with the occupancy-grid renderer, ``-O2`` with the
stratified renderer (64 + 64 samples a ray), both with SDS guidance
unless ``--guidance clip`` (random-tiny CLIP, or a local CLIP directory)
or ``none``. ``--sd_weights`` names a local diffusers SD directory or
random models (``random-full``: SD v1.5 widths; ``random-xl``: SDXL
base 1.0's, 1024² images, 128² latents); unset or
``random-full``, a directory found by the probe (``$SD_WEIGHTS_DIR``, the
mount globs) is loaded, and otherwise unset builds the random-tiny models,
as the JAX package does;
``--backbone vanilla`` takes the 5 x 128 ResMLP field. Training evaluates
every ``eval_interval`` epochs, then renders the ``--test_size``-frame
orbit at ``--H`` x ``--W`` (the grid renderer's staged eval, or the
stratified renderer in chunks) into ``<workspace>/results``
(main.py:27-42). ``--test`` renders the orbit from the latest checkpoint
without training. ``--backbone dvgo`` edits one pretrained DVGO scene: its
density and feature grids stay frozen and only its colour MLP (and the
background net, if any) trains; give ``--pretrained_dvgo`` with ``--test``
too, since the file sizes the model.

The train options: ``--jitter_pose`` jitters the camera poses,
``--dt_gamma g`` (> 0) marches with cone stepping (kernel F) and renders
the eval through the march-everything fallback, ``--ema_decay d`` keeps an
EMA of the parameters (the "best" checkpoint holds it), ``--optimizer
shampoo`` trains with block Shampoo in place of Adam. ``--n_devices N``
trains data-parallel over N ranks, one process and one card each (0 =
every visible card), with NCCL; with ``--device cpu`` over N gloo
processes on the CPU.

``--save_mesh`` exports a textured mesh (``<workspace>/mesh``: mesh.obj,
mesh.mtl, albedo.png; export/mesh.py) after the test orbit, in both
branches (rank 0 alone under ``--n_devices``). ``--gui`` opens the
interactive viewer (apps/gui.py, dearpygui) in place of the train and test
runs: it trains in bursts while it previews the field, or, with
``--test``, views the latest checkpoint. It runs one process.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from dreamfusion_torch.config import Config, parse_config
from dreamfusion_torch.guidance import none_guidance
from dreamfusion_torch.parallel import sharding
from dreamfusion_torch.training.trainer import Trainer


def run(cfg: Config,
        parallel: Optional[sharding.DataParallel] = None) -> Trainer:
    """Train (unless cfg.test), then render the orbit; one rank's share of
    it under data parallelism (rank 0 prints)."""
    say = print if parallel is None or parallel.rank == 0 else (
        lambda *a: None)
    if cfg.test:
        trainer = Trainer("df", cfg, guidance=none_guidance(
            parallel.device if parallel else cfg.device),
            workspace=cfg.workspace, use_checkpoint=cfg.ckpt,
            parallel=parallel)
    else:
        trainer = Trainer("df", cfg, workspace=cfg.workspace,
                          use_checkpoint=cfg.ckpt, parallel=parallel)
        trainer.train(max_steps=cfg.iters)
        say(f"trained to step {trainer.step}; checkpoint in "
            f"{trainer.ckpt_dir}")
    trainer.test()
    say(f"rendered {cfg.test_size} orbit frames at {cfg.H}x{cfg.W} into "
        f"{trainer.workspace}/results")
    if cfg.save_mesh and trainer.rank == 0:
        say(f"wrote {trainer.save_mesh(resolution=256)}")
    return trainer


def launch_gui(cfg: Config):
    """--gui (main.py:21-53): the viewer over a Trainer that trains from
    scratch (or the latest checkpoint), or with cfg.test over the latest
    checkpoint with no guidance. Returns the NeRFGUI after its window
    closes."""
    from dreamfusion_torch.apps.gui import NeRFGUI

    guidance = none_guidance(cfg.device) if cfg.test else None
    trainer = Trainer("df", cfg, guidance=guidance, workspace=cfg.workspace,
                      use_checkpoint=cfg.ckpt)
    gui = NeRFGUI(cfg, trainer)
    gui.render()
    return gui


def _rank(dp: sharding.DataParallel, argv: Optional[List[str]]) -> int:
    run(parse_config(argv), dp)
    return dp.rank


def main(argv=None):
    """The CLI. One rank: returns the Trainer (with --gui, the NeRFGUI).
    Several (--n_devices): the ranks run in processes of their own, and
    main returns None."""
    cfg = parse_config(argv)
    print(cfg)
    device = torch.device(cfg.device or "cuda")
    world = sharding.world_size(cfg.n_devices, device)
    if cfg.gui:
        if world > 1:
            raise ValueError("--gui runs one process; drop --n_devices")
        return launch_gui(cfg)
    if world == 1:
        return run(cfg)
    backend = "gloo" if device.type == "cpu" else "nccl"
    devices = ([device] * world if device.type == "cpu"
               else [torch.device("cuda", r) for r in range(world)])
    print(f"data parallel: {world} ranks, {backend}, on "
          f"{', '.join(map(str, devices))}")
    sharding.spawn(_rank, (argv,), devices, backend)
    return None


if __name__ == "__main__":
    main()
