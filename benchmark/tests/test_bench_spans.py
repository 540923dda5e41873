"""The readers of the program's spans inside a step (unet_device_ms.sds,
optimizer_device_ms.pretrain) on synthetic summaries, and the contract
they rest on: every span the program hands torch.profiler has a name the
trace reduction reads as a span, so that its device annotation is never
counted as a device operation."""

from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from benchkit import cells, trace


def _rec(unit, span_s, units=4):
    s = trace.Summary(window_s=1.0, busy_s=0.5, launches=10, span_s=span_s)
    return SimpleNamespace(summary=s, unit=unit, units=units)


@pytest.mark.parametrize("name,unit,span", [
    ("unet_device_ms.sds", "sds_step", "step/guidance/unet"),
    ("optimizer_device_ms.pretrain", "pretrain_step", "step/optimizer"),
])
def test_span_readers(name, unit, span):
    read = cells.metric_reader(name)
    assert read(_rec(unit, {span: 0.02, "step/render": 1.0})) == \
        pytest.approx(5.0)
    # the parent's program has no such span; another cell's unit; no trace
    assert read(_rec(unit, {"step/render": 1.0})) is None
    other = "frame" if unit == "sds_step" else "sds_step"
    assert read(_rec(other, {span: 0.02})) is None
    assert read(SimpleNamespace(summary=None, unit=unit, units=4)) is None


def test_profiled_spans_are_read_as_spans(tmp_path):
    """A tiny DVGO step and a tiny SDS step (the grid renderer, SD
    random-nano) under the CPU's profiler, the recorder on: each span of
    the program's that the profiler saw starts with one of
    trace.SPAN_PREFIXES, and the render's own spans stay out of it."""
    from dreamfusion_torch import trace as program_trace
    from dreamfusion_torch.config import Config
    from dreamfusion_torch.models.dvgo import DVGOField
    from dreamfusion_torch.training import dvgo_trainer
    from dreamfusion_torch.training.trainer import Trainer

    field = DVGOField(world_size=(6, 6, 6), k0_dim=4, rgbnet_name="resmlp",
                      rgbnet_width=16, posbase_pe=2, viewbase_pe=2)
    dtr = dvgo_trainer.DVGOTrainer(field, dvgo_trainer.DVGOStageConfig(),
                                   near=1.0, far=5.0, device="cpu")
    rng = np.random.default_rng(0)
    d = rng.normal(size=(16, 3)) * 0.2 + [0.0, 0.0, -1.0]
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.tile(np.float32([[0.1, 0.2, 3.0]]), (16, 1))
    batch = (d, o, d, rng.uniform(size=(16, 3)).astype(np.float32))
    cfg = Config(text="a cube", sd_weights="random-nano", grid_ray=True,
                 h=8, w=8, grid_size=8, max_steps=32, H=12, W=12,
                 albedo_iters=0, device="cpu",
                 workspace=str(tmp_path)).finalize()
    tr = Trainer("t", cfg, use_checkpoint="scratch")
    program_trace.reset()
    program_trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            dtr.step(batch)
            tr.advance()
    finally:
        program_trace.disable()
    program = {r.name for r in program_trace.records()}
    program_trace.reset()
    seen = {e.name for e in prof.events() if e.is_user_annotation} & program
    assert {"step/loss", "step/guidance/unet", "grid_refresh"} <= seen
    assert all(n.startswith(trace.SPAN_PREFIXES) for n in seen), seen
    assert program - seen == {"render/march", "render/field",
                              "render/composite"}
