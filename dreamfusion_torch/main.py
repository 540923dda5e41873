"""dreamfusion_torch CLI: train one text-to-3D asset on the GPU, then render
its 360-degree orbit.

  python -m dreamfusion_torch.main -O --text "a hamburger" --iters 5000
  python -m dreamfusion_torch.main -O --text "a hamburger" --test
  python -m dreamfusion_torch.main -O2 --text "a hamburger"
  python -m dreamfusion_torch.main -O2 --backbone vanilla --guidance clip \
      --clip_weights random-tiny --text "a hamburger"
  python -m dreamfusion_torch.main -O --backbone dvgo \
      --pretrained_dvgo scene.dvgo --bg_radius 0 --text "a golden ficus"

``-O`` trains with the occupancy-grid renderer, ``-O2`` with the
stratified renderer (64 + 64 samples a ray), both with SDS guidance on
randomly initialised SD v1.5-sized models (``--sd_weights random-full``,
the default) unless ``--guidance clip`` (random-tiny CLIP) or ``none``;
``--backbone vanilla`` takes the 5 x 128 ResMLP field. Training evaluates
every ``eval_interval`` epochs, then renders the ``--test_size``-frame
orbit at ``--H`` x ``--W`` (the grid renderer's staged eval, or the
stratified renderer in chunks) into ``<workspace>/results``
(main.py:27-42). ``--test`` renders the orbit from the latest checkpoint
without training. ``--backbone dvgo`` edits one pretrained DVGO scene: its
density and feature grids stay frozen and only its colour MLP (and the
background net, if any) trains; give ``--pretrained_dvgo`` with ``--test``
too, since the file sizes the model. Mesh export and the GUI are not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dreamfusion_torch.config import parse_config
from dreamfusion_torch.guidance import none_guidance
from dreamfusion_torch.training.trainer import Trainer


def main(argv=None) -> Trainer:
    cfg = parse_config(argv)
    print(cfg)
    if cfg.test:
        trainer = Trainer("df", cfg, guidance=none_guidance(cfg.device),
                          workspace=cfg.workspace, use_checkpoint=cfg.ckpt)
    else:
        trainer = Trainer("df", cfg, workspace=cfg.workspace,
                          use_checkpoint=cfg.ckpt)
        trainer.train(max_steps=cfg.iters)
        print(f"trained to step {trainer.step}; checkpoint in "
              f"{trainer.ckpt_dir}")
    trainer.test()
    print(f"rendered {cfg.test_size} orbit frames at {cfg.H}x{cfg.W} into "
          f"{trainer.workspace}/results")
    return trainer


if __name__ == "__main__":
    main()
