"""The reduction of one torch.profiler trace of a stretch of the window.

``profiled(fn)`` runs fn under the profiler (CPU and CUDA activities) and
returns a ``Summary``:

- ``window_s``: the stretch's length on the host clock, ending in a device
  synchronize;
- ``busy_s``: the union of the device's intervals (kernels, copies, sets);
- ``launches``: the device operations;
- ``device_ops``: seconds by device operation name;
- ``span_s``: the device seconds of the kernels launched under each
  ``record_function`` span (the span's own launches and its children's);
- ``idle_gaps``: the device's idle seconds inside the stretch, by the
  innermost span the host was in at each gap's middle.

The per-layer metrics (metrics/*.py) read these."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple

import torch

SPAN_PREFIXES = ("step/", "eval/", "grid_refresh", "bench/")


@dataclass
class Summary:
    window_s: float
    busy_s: float
    launches: int
    device_ops: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    span_s: Dict[str, float] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def kernel(self, needle: str) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        needle."""
        s = n = 0
        for name, (sec, cnt) in self.device_ops.items():
            if needle in name:
                s += sec
                n += cnt
        return s, n

    def breakdown(self, top: int = 10) -> Dict:
        """The device operations that took most time (names cut to 160
        characters) and the largest idle gaps by host span."""
        ops = sorted(self.device_ops.items(), key=lambda kv: -kv[1][0])[:top]
        return {"device_ops": [[k[:160], v[0]] for k, v in ops],
                "idle_gaps": [list(g) for g in self.idle_gaps[:top]]}


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def _dev_total_us(e) -> float:
    return getattr(e, "device_time_total", None) or getattr(
        e, "cuda_time_total", 0.0)


def summarize(events: Sequence, window_s: float,
              spans: Sequence[str] = SPAN_PREFIXES) -> Summary:
    """Summary of a profiler's events (prof.events()) over a stretch of
    window_s seconds."""
    spans = tuple(spans)
    dev, host = [], []
    for e in events:
        name = e.name
        if _is_device(e):
            if name.startswith(spans):
                continue                 # a span's annotation on the device
            dev.append((e.time_range.start, e.time_range.end, name))
        elif name.startswith(spans):
            host.append((e.time_range.start, e.time_range.end, name,
                         _dev_total_us(e)))
    ops: Dict[str, Tuple[float, int]] = {}
    for s, t, name in dev:
        sec, cnt = ops.get(name, (0.0, 0))
        ops[name] = (sec + (t - s) * 1e-6, cnt + 1)
    span_s: Dict[str, float] = {}
    for _, _, name, us in host:
        span_s[name] = span_s.get(name, 0.0) + us * 1e-6
    # the union of the device's intervals, and the gaps between them
    dev.sort()
    busy_us, gaps = 0.0, []
    cur_s = cur_t = None
    for s, t, _ in dev:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy_us += cur_t - cur_s
                gaps.append((cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy_us += cur_t - cur_s
    host.sort()
    by_span: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inner = "outside the spans"
        for s, t, name, _ in host:
            if s > mid:
                break
            if t >= mid:
                inner = name             # the latest-starting span holding mid
        by_span[inner] = by_span.get(inner, 0.0) + (b - a) * 1e-6
    idle = sorted(by_span.items(), key=lambda kv: -kv[1])
    return Summary(window_s=window_s, busy_s=busy_us * 1e-6,
                   launches=len(dev), device_ops=ops, span_s=span_s,
                   idle_gaps=idle)


def profiled(fn: Callable[[], None]) -> Summary:
    """fn() under torch.profiler, synchronized at both ends."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return summarize(prof.events(), window_s)
