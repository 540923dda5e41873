"""dreamfusion_torch CLI: train one text-to-3D asset on the GPU.

  python -m dreamfusion_torch.main -O --text "a hamburger" --iters 5000

Trains with the occupancy-grid renderer and SDS guidance on randomly
initialised SD v1.5-sized models (``--sd_weights random-full``, the
default), then saves a checkpoint under ``<workspace>/checkpoints``. The
staged eval, the 360-degree test render and mesh export belong to slice 2
of the port (ROADMAP.md): ``--test`` raises, and a training run does not
render them.
"""

from __future__ import annotations

from dreamfusion_torch.config import parse_config
from dreamfusion_torch.training.trainer import Trainer


def main(argv=None) -> Trainer:
    cfg = parse_config(argv)
    print(cfg)
    if cfg.test:
        raise NotImplementedError(
            "--test (the 360-degree orbit render) belongs to slice 2 of the "
            "PyTorch port; see ROADMAP.md")
    trainer = Trainer("df", cfg, workspace=cfg.workspace,
                      use_checkpoint=cfg.ckpt)
    trainer.train(max_steps=cfg.iters)
    print(f"trained to step {trainer.step}; checkpoint in {trainer.ckpt_dir}")
    print("not run: Trainer.test() and Trainer.evaluate() (slice 2 of the "
          "port, ROADMAP.md)")
    return trainer


if __name__ == "__main__":
    main()
