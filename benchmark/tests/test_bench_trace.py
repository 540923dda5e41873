"""The trace reduction on a small recorded profile: device intervals, the
idle share, the spans' device time and the idle gaps' attribution."""

from types import SimpleNamespace

import pytest

from benchkit import trace


def ev(name, start, end, device, dev_total=0.0):
    return SimpleNamespace(
        name=name, device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        time_range=SimpleNamespace(start=start, end=end),
        device_time_total=dev_total)


# microseconds: two host spans, four device operations (two overlapping),
# one device annotation of a span (not an operation)
EVENTS = [
    ev("step/render", 0, 400, False, dev_total=250.0),
    ev("step/guidance", 400, 1000, False, dev_total=300.0),
    ev("aten::mm", 10, 20, False),
    ev("kernel_a", 100, 200, True),
    ev("kernel_b", 150, 250, True),          # overlaps kernel_a
    ev("Memcpy HtoD", 500, 600, True),
    ev("kernel_a", 800, 900, True),
    ev("step/guidance", 400, 1000, True),    # the span's GPU annotation
]


def test_summary_arithmetic():
    s = trace.summarize(EVENTS, window_s=1e-3)
    # union: [100, 250] + [500, 600] + [800, 900] = 350 us
    assert s.busy_s == pytest.approx(350e-6)
    assert s.launches == 4
    assert s.device_ops["kernel_a"] == pytest.approx((200e-6, 2))
    assert s.kernel("kernel") == pytest.approx((300e-6, 3))
    assert s.span_s == pytest.approx({"step/render": 250e-6,
                                      "step/guidance": 300e-6})
    # gaps 250-500 (mid 375, in step/render) and 600-800 (in guidance)
    assert dict(s.idle_gaps) == pytest.approx({"step/render": 250e-6,
                                               "step/guidance": 200e-6})
    b = s.breakdown()
    assert b["device_ops"][0][0] == "kernel_a"
    assert b["idle_gaps"][0] == ["step/render", pytest.approx(250e-6)]


def test_idle_share_reader():
    from benchkit import cells

    s = trace.summarize(EVENTS, window_s=1e-3)
    rec = SimpleNamespace(summary=s, unit="sds_step", units=2)
    share = cells.metric_reader("device_idle_share.sds")(rec)
    assert share == pytest.approx(65.0)
    assert cells.metric_reader("launches_per_step.sds")(rec) == 2.0
    assert cells.metric_reader("render_device_ms.sds")(rec) == \
        pytest.approx(0.125)
    # a trace with no device operation reads nothing
    empty = SimpleNamespace(summary=trace.summarize([], 1.0),
                            unit="sds_step", units=1)
    assert cells.metric_reader("device_idle_share.sds")(empty) is None


def test_memory_and_window_readers():
    from benchkit import cells

    rec = SimpleNamespace(unit="sds_step", run_peak_bytes=3 * 2 ** 30,
                          resident_bytes=2 ** 30, stretch_peak_bytes=2 ** 31,
                          window_units=30, window_seconds=6.0)
    read = lambda name, r: cells.metric_reader(name)(r)  # noqa: E731
    assert read("train_peak_gib", rec) == 3.0
    assert read("resident_gib.sds", rec) == 1.0
    assert read("step_peak_gib.sds", rec) == 2.0
    assert read("sds_steps_per_s.grid", rec) == 5.0
    # a run that marked no first step, or had no timed window, reads nothing
    bare = SimpleNamespace(unit="sds_step", run_peak_bytes=0,
                           resident_bytes=0, stretch_peak_bytes=0,
                           window_units=None, window_seconds=None)
    for name in ("train_peak_gib", "resident_gib.sds", "step_peak_gib.sds",
                 "sds_steps_per_s.grid"):
        assert read(name, bare) is None


def test_traced_run_times_a_window_for_host_clock_metrics(monkeypatch):
    """A traced run of a cell with a per-layer metric on the host's clock
    runs the timed window before the profiled stretch, and reads the rate
    from the window; the CPU has no profiler of the card, so the stretch
    is timed alone here."""
    import time

    import runners.sds
    from benchkit import harness
    from dreamfusion_torch.guidance.sd import layers
    from tiny import tiny_cell

    def stretch_only(fn):
        t = time.perf_counter()
        fn()
        w = time.perf_counter() - t
        return trace.Summary(window_s=w, busy_s=w / 2, launches=1)

    monkeypatch.setattr(runners.sds, "profiled", stretch_only)
    monkeypatch.setattr(layers, "GN_DTYPE", "f32")
    cell = tiny_cell("grid_sd15.sds_train")
    res, _ = harness.run(cell.name, 2 ** 33 + 5, 0.3, True,
                         time.perf_counter(), device="cpu", cell=cell)
    assert res["correct"]
    assert res["metrics"]["sds_steps_per_s.grid"]["value"] > 0
    assert res["attempted"] > cell.mix["trace_steps"]
