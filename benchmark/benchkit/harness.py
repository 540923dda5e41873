"""One run of one cell: set-up, the measured window (or, traced, a
stretch of it under the profiler, after the measured window where a
per-layer metric reads the host's clock), the metrics by their readers,
then the comparison with the plain reference once the program's state is
freed.

``run`` returns (result, checks): the result line's object and the
numbers compared, each with its limit. run.py prints them."""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import torch

from benchkit import cells, device as devinfo


def loop(step: Callable[[], object], n: Optional[int] = None,
         seconds: Optional[float] = None,
         stamps: Optional[List[float]] = None) -> Tuple[int, List]:
    """Call step() n times, or until `seconds` of host time have passed;
    returns (calls, what each returned). `stamps`, where given, gets the
    host clock at the start and after each call."""
    out = []
    t0 = time.perf_counter()
    if stamps is not None:
        stamps.append(t0)
    while (n is not None and len(out) < n) or (
            seconds is not None and time.perf_counter() - t0 < seconds):
        out.append(step())
        if stamps is not None:
            stamps.append(time.perf_counter())
    return len(out), out


def _window_note(stamps: List[float], cpu_s: float) -> None:
    """The window's host side on standard error: the calls' host times
    and the process's CPU seconds (a host-bound loop's rate follows the
    CPU time a call takes)."""
    d = sorted(b - a for a, b in zip(stamps, stamps[1:]))
    if not d:
        return
    q = lambda f: 1e3 * d[min(len(d) - 1, int(f * len(d)))]  # noqa: E731
    med = d[len(d) // 2]
    slow = sum(x - med for x in d if x > 2 * med)
    print(f"[window] {len(d)} calls, ms p10 {q(0.1):.1f} p50 {q(0.5):.1f} "
          f"p90 {q(0.9):.1f} max {1e3 * d[-1]:.1f}; {slow:.2f} s beyond 2x "
          f"the median; process CPU {cpu_s:.2f} s, "
          f"{1e3 * cpu_s / len(d):.1f} ms a call", file=sys.stderr, flush=True)


def _nonfinite(values: List) -> int:
    if not values:
        return 0
    v = torch.stack([torch.as_tensor(x, dtype=torch.float32).reshape(())
                     .to(values[0].device if torch.is_tensor(values[0])
                         else "cpu") for x in values])
    return int((~torch.isfinite(v)).sum())


def _read(specs: List[Dict], record) -> Dict[str, Dict]:
    out = {}
    for m in specs:
        v = cells.metric_reader(m["name"])(record)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda",
        cell: Optional[cells.Cell] = None) -> Tuple[Dict, Dict]:
    cell = cell or cells.load_cell(workload)
    cuda = torch.device(device).type == "cuda"
    mod = cells.runner(cell.mix["runner"])
    r = mod.Run(cell, seed, device=device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    peak_before = getattr(r, "peak_before_training", 0)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    record = SimpleNamespace(unit=r.unit, setup_s=setup_s, config=cell.config,
                             mix=cell.mix, summary=None, extra={},
                             resident_bytes=(torch.cuda.memory_allocated()
                                             if cuda else 0),
                             stretch_peak_bytes=0, window_units=None,
                             window_seconds=None)
    values: List = []
    if not trace or any(m["source"] == "host_clock" for m in cell.per_layer):
        # the timed window; a traced run has it too where a per-layer
        # metric reads the host's clock, which the profiler would slow
        stamps: List[float] = []
        c0 = time.process_time()
        t0 = time.perf_counter()
        n, out = r.steps(seconds=seconds, stamps=stamps)
        if cuda:
            torch.cuda.synchronize()
        record.window_units, record.window_seconds = n, time.perf_counter() - t0
        values += out
        _window_note(stamps, time.process_time() - c0)
        if hasattr(r, "window_note"):
            r.window_note()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if trace:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        summary, extra = r.trace()
        if cuda:
            record.stretch_peak_bytes = torch.cuda.max_memory_allocated()
            window_peak = max(window_peak, record.stretch_peak_bytes)
        record.summary, record.extra = summary, extra
        record.units, record.seconds = extra["units"], summary.window_s
        values += extra["losses"]
    else:
        record.units, record.seconds = record.window_units, record.window_seconds
    record.peak_bytes = window_peak
    # from the program's first step on, where the runner marks it
    record.run_peak_bytes = (max(peak, window_peak)
                             if hasattr(r, "peak_before_training") else 0)
    if cuda:
        since = (f", {record.run_peak_bytes / 2 ** 30:.4f} from the program's "
                 f"first step" if record.run_peak_bytes else "")
        print(f"[window] peak {window_peak / 2 ** 30:.4f} GiB in the window"
              f"{since}", file=sys.stderr, flush=True)
    metrics = _read(cell.per_layer if trace else cell.end_to_end, record)
    failed = _nonfinite(values)
    attempted = len(values)
    dev = (devinfo.describe(cell.chips, max(peak_before, peak, window_peak))
           if cuda
           else {"platform": "cpu", "kind": "cpu", "count": 0,
                 "memory_peak_bytes": 0})
    if trace:
        dev["busy_s"] = record.summary.busy_s
        dev["window_s"] = record.summary.window_s
    r.release()
    try:
        readings = mod.readings(r.program_record(), r.reference())
    finally:
        r.close()
    checks = {k: {"value": readings[k], "limit": v}
              for k, v in cell.limits.items()}
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in checks.values())
    for k in sorted(set(readings) - set(checks)):
        print(f"reading {k}: {readings[k]!r} (not compared, PERF.md)",
              file=sys.stderr)
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace:
        result["breakdown"] = record.summary.breakdown()
    return result, checks
