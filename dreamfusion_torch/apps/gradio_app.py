"""Gradio web demo: prompt -> progressive text-to-3D preview (counterpart of
dreamfusion_tpu/apps/gradio_app.py; reference gradio_app.py).

``submit_generator`` trains one asset and yields a preview image every
``preview_every`` steps, then the first frame of the 360-degree orbit; it
runs without gradio. ``build_app`` wraps it in gradio Blocks when gradio is
installed.

    python -m dreamfusion_torch.apps.gradio_app
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from dreamfusion_torch.config import Config


def submit_generator(text: str, iters: int = 500, seed: int = 0,
                     workspace: str = "gradio_trial", preview_every: int = 8,
                     cfg_overrides: Optional[dict] = None
                     ) -> Iterator[Tuple[np.ndarray, str]]:
    """Train and yield (preview image [H, W, 3] float in [0, 1], status),
    then (orbit frame 0 uint8, status) (reference gradio_app.py:129-197:
    the grid NeRF, view-dependent prompts, EMA 0.95, 64^2 renders and
    128^2 previews)."""
    from dreamfusion_torch.apps.gui import NeRFGUICore
    from dreamfusion_torch.training.trainer import Trainer

    kw = dict(text=text, seed=seed, iters=iters, workspace=workspace,
              backbone="grid", dir_text=True, ema_decay=0.95,
              guidance="stable-diffusion", h=64, w=64, W=128, H=128)
    kw.update(cfg_overrides or {})
    cfg = Config(**kw)
    trainer = Trainer("df", cfg, use_checkpoint="scratch")
    core = NeRFGUICore(cfg, trainer)
    core.train_steps = preview_every

    while core.step < iters:
        tlog = core.train_step()
        core.need_update = True
        core.test_step()
        yield core.render_buffer, (f"step {core.step}/{iters} "
                                   f"loss={tlog['loss']:.4f}")
    frames = trainer.test(size=36)
    yield frames[0], f"done: {len(frames)}-frame orbit in {workspace}/results"


def build_app():
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError("the web demo needs gradio (pip install gradio); "
                          "submit_generator works headlessly") from e

    with gr.Blocks(title="dreamfusion_torch") as app:
        gr.Markdown("# dreamfusion_torch: text to 3D")
        with gr.Row():
            text = gr.Textbox(label="prompt",
                              value="a DSLR photo of a hamburger")
            iters = gr.Slider(100, 10000, value=500, step=100, label="iters")
            seed = gr.Number(value=0, precision=0, label="seed")
        button = gr.Button("Generate")
        image = gr.Image(label="preview")
        status = gr.Textbox(label="status")

        def run(text, iters, seed):
            for img, msg in submit_generator(text, int(iters), int(seed)):
                yield img, msg

        button.click(run, inputs=[text, iters, seed], outputs=[image, status])
    return app


if __name__ == "__main__":
    build_app().launch()
