"""The port's span recorder (dreamfusion_torch/trace.py) on the CPU: off
and on, nesting and self time, the clock it shares with torch.profiler,
the sync counter (a stub flagged call: the CPU has no CUDA sync), the
spans a tiny DVGO step and a tiny SDS step enter, and the device time of
a synthetic trace put to the spans that launched it."""

import statistics
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dreamfusion_torch import trace
from dreamfusion_torch.config import Config
from dreamfusion_torch.models import dvgo
from dreamfusion_torch.training import dvgo_trainer
from dreamfusion_torch.training.trainer import Trainer


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty again afterwards."""
    trace.reset()
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()
        trace.reset()
        trace.set_id(None)


def _flagged_sync():
    """What PyTorch's sync debug mode raises for a synchronizing call."""
    warnings.warn(trace.SYNC_MESSAGE + " (a stub)", UserWarning)


def test_off_keeps_no_record_and_profiles_spans():
    trace.reset()
    with trace.span("step/render"):
        pass
    assert trace.records() == [] and trace.table() == {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("step/render"):
            torch.ones(4).sum()
        with trace.span("render/field", profile=False):
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "step/render" in names and "render/field" not in names
    assert trace.records() == []


def test_nesting_parent_self_time_and_shared_id(recorder):
    trace.set_id(7)
    with trace.span("step/render"):
        time.sleep(0.02)
        with trace.span("render/field"):
            time.sleep(0.01)
        with trace.span("render/field"):
            time.sleep(0.01)
    trace.set_id(8)
    with trace.span("step/guidance"):
        pass
    recs = trace.records()
    assert [r.name for r in recs] == ["step/render", "render/field",
                                      "render/field", "step/guidance"]
    assert [r.parent for r in recs] == [-1, 0, 0, -1]
    assert [r.id for r in recs] == [7, 7, 7, 8]
    assert all(r.end_ns >= r.start_ns for r in recs)
    t = trace.table()
    assert t["render/field"]["calls"] == 2
    children = sum(r.end_ns - r.start_ns for r in recs[1:3])
    assert t["render/field"]["host_ns"] == children
    assert t["step/render"]["self_ns"] == \
        t["step/render"]["host_ns"] - children
    assert t["step/render"]["self_ns"] >= 0.02e9
    assert t["render/field"]["self_ns"] == t["render/field"]["host_ns"]


def test_records_share_the_profilers_clock(recorder):
    """A span's recorded start and end lie within 50 us of the profiler's
    own stamps of it (trace_start_ns + time_range), after a warm-up span;
    the median of five spans, so that a descheduled thread in a loaded
    test run does not decide it."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("step/warm"):
            torch.ones(8).sum()
        for _ in range(5):
            with trace.span("step/x"):
                torch.ones(8).sum()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    prof_spans = sorted((e.time_range.start, e.time_range.end)
                        for e in prof.events() if e.name == "step/x")
    recs = [r for r in trace.records() if r.name == "step/x"]
    assert len(prof_spans) == len(recs) == 5
    d_start = [abs(r.start_ns - (start_ns + 1e3 * s))
               for r, (s, _) in zip(recs, prof_spans)]
    d_end = [abs(r.end_ns - (start_ns + 1e3 * e))
             for r, (_, e) in zip(recs, prof_spans)]
    assert statistics.median(d_start) < 50e3
    assert statistics.median(d_end) < 50e3


def test_syncs_count_on_the_innermost_span(recorder):
    with trace.span("eval/march"):
        _flagged_sync()
        with trace.span("eval/shade"):
            _flagged_sync()
            _flagged_sync()
    _flagged_sync()
    with pytest.warns(UserWarning, match="not a sync"):
        warnings.warn("not a sync", UserWarning)   # passed on, not counted
    t = trace.table()
    assert t["eval/march"]["syncs"] == 1 and t["eval/shade"]["syncs"] == 2
    assert t[trace.OUTSIDE] == {"calls": 0, "host_ns": 0, "self_ns": 0,
                                "syncs": 1}


def test_disable_restores_the_warning_filters():
    before = (list(warnings.filters), warnings.showwarning)
    trace.enable()
    assert warnings.showwarning is not before[1]
    trace.disable()
    trace.reset()
    assert (list(warnings.filters), warnings.showwarning) == before
    with pytest.warns(UserWarning, match="synchronizing"):
        _flagged_sync()                            # shown again once off
    assert trace.table() == {}


def test_dvgo_step_enters_its_spans(recorder):
    torch.manual_seed(0)
    field = dvgo.DVGOField(world_size=(6, 6, 6), k0_dim=4,
                           rgbnet_name="resmlp", rgbnet_width=16,
                           posbase_pe=2, viewbase_pe=2, alpha_init=1e-2)
    tr = dvgo_trainer.DVGOTrainer(
        field, dvgo_trainer.DVGOStageConfig(weight_tv_density=0.01),
        near=1.0, far=5.0, device="cpu")
    rng = np.random.default_rng(0)
    d = np.array([[0.0, 0.0, -1.0]]) + 0.2 * rng.normal(size=(16, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = np.tile(np.float32([[0.1, 0.2, 3.0]]), (16, 1))
    batch = (d, o, d, rng.uniform(size=(16, 3)).astype(np.float32))
    tr.step(batch)
    tr.step(batch)
    recs = trace.records()
    assert [r.name for r in recs] == 2 * ["step/render", "step/loss",
                                          "step/backward", "step/optimizer"]
    assert [r.id for r in recs] == 4 * [0] + 4 * [1]
    assert all(r.parent == -1 for r in recs)


def test_sds_step_enters_its_spans(recorder, tmp_path):
    """One Trainer.advance of a tiny -O run with SD random-nano: the
    step's spans, the guidance's VAE encode and UNet inside step/guidance,
    the render's inside step/render, the refresh before them."""
    cfg = Config(text="a cube", sd_weights="random-nano", grid_ray=True,
                 h=8, w=8, grid_size=8, max_steps=32, iters=4, H=12, W=12,
                 albedo_iters=0, device="cpu",
                 workspace=str(tmp_path)).finalize()
    tr = Trainer("t", cfg, use_checkpoint="scratch")
    trace.reset()
    tr.advance()
    recs = trace.records()
    names = [r.name for r in recs]
    assert names[0] == "grid_refresh"
    for name in ("step/cameras", "step/render", "step/guidance",
                 "step/backward", "step/optimizer", "render/march",
                 "render/field", "render/composite",
                 "step/guidance/vae_encode", "step/guidance/unet"):
        assert name in names, name
    parent = {r.name: recs[r.parent].name for r in recs if r.parent >= 0}
    assert parent["step/guidance/unet"] == "step/guidance"
    assert parent["step/guidance/vae_encode"] == "step/guidance"
    assert parent["render/march"] == parent["render/composite"] == \
        "step/render"
    assert {r.id for r in recs if r.name.startswith(("step/", "render/"))} \
        == {0}


def _ev(name, start, end, device, thread=1, id=0, annotation=False):
    return SimpleNamespace(
        name=name, id=id, thread=thread,
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        time_range=SimpleNamespace(start=start, end=end),
        is_user_annotation=annotation)


def test_launched_by_span_puts_autograd_launches_to_the_waiting_span():
    """Synthetic trace (us from a start of 1 s): the main thread's
    step/backward span holds a launch from thread 2 (autograd's); a
    launch under render/field inside step/render; one outside any span;
    the device annotation of a span is not an operation."""
    t0 = 10 ** 9
    recs = [trace.Record("step/render", -1, 0, t0 + 100_000, t0 + 200_000),
            trace.Record("render/field", 0, 0, t0 + 120_000, t0 + 150_000),
            trace.Record("step/backward", -1, 0, t0 + 300_000, t0 + 400_000)]
    events = [
        _ev("cudaLaunchKernel", 130, 131, False, id=11),     # render/field
        _ev("kernel_a", 135, 145, True, id=11),
        _ev("cudaLaunchKernel", 160, 161, False, id=12),     # step/render
        _ev("kernel_b", 165, 170, True, id=12),
        _ev("cudaLaunchKernel", 350, 351, False, thread=2, id=13),
        _ev("kernel_c", 355, 395, True, id=13),               # backward
        _ev("cudaMemcpyAsync", 500, 501, False, id=14),      # outside
        _ev("Memcpy HtoD", 502, 510, True, id=14),
        _ev("step/render", 135, 170, True, annotation=True),
    ]
    got = trace.launched_by_span(events, t0, recs)
    assert got == pytest.approx({"render/field": 10e-6, "step/render": 5e-6,
                                 "step/backward": 40e-6,
                                 trace.OUTSIDE: 8e-6})
