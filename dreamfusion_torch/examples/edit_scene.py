"""Single-scene appearance editing, the fork's own use case (counterpart of
examples/edit_scene.py).

Script equivalent of the reference's run.ipynb (cell 3: prompt "a DSLR
photo of a green ficus", 500 iterations, lr 1e-3, 64x64 renders,
bg_radius=0, max_steps=512, on a pretrained DVGO scene):

    python -m dreamfusion_torch.examples.edit_scene \\
        --pretrained_dvgo /data/scene.dvgo \\
        --text "a DSLR photo of a green ficus"

Train a fresh .dvgo first with the pipeline if you have none:

    python -c "from dreamfusion_torch.training.jobs import train_model, \\
                   params_for_nerf; \\
               train_model(params_for_nerf('/data/nerf_synthetic/ficus', \\
                                           save_name='ficus.dvgo'))"

It runs on the GPU; --device cpu runs the plain PyTorch path on the CPU.
"""

import argparse

from dreamfusion_torch.config import Config
from dreamfusion_torch.training.trainer import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser("edit_scene")
    ap.add_argument("--pretrained_dvgo", required=True)
    ap.add_argument("--text", default="a DSLR photo of a green ficus")
    ap.add_argument("--iters", type=int, default=500)
    ap.add_argument("--workspace", default="trial_edit")
    ap.add_argument("--guidance", default="stable-diffusion")
    ap.add_argument("--sd_weights", default=None)
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = Config(
        text=args.text, guidance=args.guidance, sd_weights=args.sd_weights,
        backbone="dvgo", pretrained_dvgo=args.pretrained_dvgo,
        iters=args.iters, lr=1e-3, h=64, w=64,
        bg_radius=0.0, max_steps=512, dir_text=True, fp16=True,
        workspace=args.workspace, device=args.device,
    ).finalize()

    trainer = Trainer("edit", cfg)
    trainer.train(max_steps=cfg.iters)
    trainer.test(size=36)   # 360-degree video frames + gif
    trainer.save_mesh(resolution=256)
    return trainer


if __name__ == "__main__":
    main()
