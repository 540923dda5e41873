"""The port's one span recorder: named host spans at the layers'
boundaries, kept in memory, with the host syncs counted on the span that
made them.

    from dreamfusion_torch import trace

    with trace.span("step/render"):
        ...

Off (the default) a span costs a flag check, and enters
``torch.profiler.record_function(name)`` while a torch.profiler is
active, so that a device trace carries it under its name. A span made
with ``profile=False`` never enters the profiler: the benchmark's trace
reduction (benchmark/benchkit/trace.py) reads a span's device annotation
as a device operation unless its name starts with ``step/``, ``eval/`` or
``grid_refresh``, so spans of other names stay out of the device trace.

On (``enable()`` / ``disable()`` / ``reset()``) every span also keeps a
``Record``: its name, its parent (the index of the enclosing record in
``records()``, -1 for none), the shared id set by ``set_id`` (the
Trainer's step, a count of ``DVGOTrainer.step`` calls, or the orbit
frame), and its host start and end in ns on the clock that torch.profiler
stamps its events with (``time.time_ns()``), so the records and a device
trace share one time axis. Nothing is written while the program runs.

While the recorder is on, on a machine with CUDA, PyTorch's sync debug
mode is "warn": each synchronizing call it flags (``.item()``, ``.cpu()``,
``nonzero``, a blocking copy; not ``torch.cuda.synchronize()``) is
counted on the innermost open span, or as ``OUTSIDE``, and its warning
swallowed. A sync in autograd's backward thread counts on the span the
main thread waits in. ``disable()`` restores the mode and the warning
filters as they were.

Spans nest on one thread, the one that runs the program's steps.
``table()`` sums the records by name; ``launched_by_span`` puts the
device operations of a torch.profiler trace taken with the recorder on
to the spans that launched them, autograd's thread included.
"""

from __future__ import annotations

import bisect
import contextlib
import time
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

SYNC_MESSAGE = "called a synchronizing CUDA operation"
OUTSIDE = "outside the spans"


@dataclass
class Record:
    name: str
    parent: int
    id: Optional[int]
    start_ns: int
    end_ns: int = 0
    syncs: int = 0


_on = False
_records: List[Record] = []
_stack: List[int] = []            # indices of the open records
_id: Optional[int] = None
_outside_syncs = 0
# while on: (the warning filters saved, the sync debug mode saved, the
# showwarning that other warnings go on to)
_saved = None


def _count_sync(message, category, filename, lineno, file=None, line=None):
    global _outside_syncs
    if not str(message).startswith(SYNC_MESSAGE):
        _saved[2](message, category, filename, lineno, file, line)
    elif _stack:
        _records[_stack[-1]].syncs += 1
    else:
        _outside_syncs += 1


def enable() -> None:
    """Keep records and count syncs from here on (records kept so far
    stay; reset() drops them)."""
    global _on, _saved
    if _on:
        return
    filters = warnings.catch_warnings()
    filters.__enter__()
    mode = None
    if torch.cuda.is_available():
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # "a prototype feature"
            torch.cuda.set_sync_debug_mode("warn")
    _saved = (filters, mode, warnings.showwarning)
    warnings.filterwarnings("always", message=SYNC_MESSAGE)
    warnings.showwarning = _count_sync
    _on = True


def disable() -> None:
    """Stop recording; restore the sync debug mode and the warning
    filters. The records stay until reset()."""
    global _on, _saved
    if not _on:
        return
    _on = False
    filters, mode, _ = _saved
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    filters.__exit__(None, None, None)
    _saved = None


def reset() -> None:
    """Drop every record and count (spans open now stay open, unrecorded)."""
    global _outside_syncs
    _records.clear()
    _stack.clear()
    _outside_syncs = 0


def set_id(i: Optional[int]) -> None:
    """The shared id of the spans opened from here on."""
    global _id
    _id = i


class _Span:
    __slots__ = ("name", "profile", "_rf", "_i")

    def __init__(self, name: str, profile: bool):
        self.name = name
        self.profile = profile
        self._rf = None
        self._i = -1

    def __enter__(self):
        if self.profile and _autograd_profiler._is_profiler_enabled:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        if _on:
            self._i = len(_records)
            _records.append(Record(self.name, _stack[-1] if _stack else -1,
                                   _id, time.time_ns()))
            _stack.append(self._i)
        return self

    def __exit__(self, *exc):
        # a span open across reset() is no longer on the stack: spans
        # nest, so the stack is empty again when it ends
        if self._i >= 0 and _stack and _stack[-1] == self._i:
            _records[self._i].end_ns = time.time_ns()
            _stack.pop()
        self._i = -1
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        return False


_NO_SPAN = contextlib.nullcontext()


def span(name: str, profile: bool = True):
    """``with span(name):`` a span of the program (see the module's
    docstring); profile=False keeps it out of torch.profiler's trace.
    With the recorder off and no profiler, a shared context that does
    nothing."""
    if _on or (profile and _autograd_profiler._is_profiler_enabled):
        return _Span(name, profile)
    return _NO_SPAN


def records() -> List[Record]:
    """The records kept, in the order their spans opened."""
    return list(_records)


def table() -> Dict[str, Dict]:
    """Per span name: calls, host_ns, self_ns (host_ns less the part its
    child spans cover) and syncs, over the closed records. Syncs made
    outside every span appear under OUTSIDE."""
    recs = _records
    child_ns = [0] * len(recs)
    for r in recs:
        if r.end_ns and r.parent >= 0:
            child_ns[r.parent] += r.end_ns - r.start_ns
    out: Dict[str, Dict] = {}
    for r, c in zip(recs, child_ns):
        if not r.end_ns:
            continue
        row = out.setdefault(r.name, {"calls": 0, "host_ns": 0, "self_ns": 0,
                                      "syncs": 0})
        dur = r.end_ns - r.start_ns
        row["calls"] += 1
        row["host_ns"] += dur
        row["self_ns"] += dur - c
        row["syncs"] += r.syncs
    if _outside_syncs:
        out[OUTSIDE] = {"calls": 0, "host_ns": 0, "self_ns": 0,
                        "syncs": _outside_syncs}
    return out


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def launched_by_span(events: Sequence, trace_start_ns: int,
                     recs: Optional[Sequence[Record]] = None
                     ) -> Dict[str, float]:
    """Device seconds by span name of a torch.profiler trace taken with
    the recorder on: each device operation goes to the innermost span
    that was open, on any host thread, when the runtime call that
    launched it started (the call shares the operation's correlation
    id), so the kernels autograd's thread launches during a backward fall
    to the span the main thread waits in; OUTSIDE holds the rest. events:
    prof.events(); trace_start_ns: the profiler's
    kineto_results.trace_start_ns(), from which events are stamped in us;
    recs: records() (the default), whole, as parents index into it."""
    recs = records() if recs is None else recs
    order = sorted(range(len(recs)), key=lambda i: recs[i].start_ns)
    starts = [recs[i].start_ns for i in order]
    launch_us = {e.id: e.time_range.start for e in events
                 if not _is_device(e) and e.name.startswith("cu")}
    out: Dict[str, float] = {}
    for e in events:
        if not _is_device(e) or e.is_user_annotation:
            continue
        name = OUTSIDE
        if e.id in launch_us:
            t_ns = trace_start_ns + 1e3 * launch_us[e.id]
            k = bisect.bisect_right(starts, t_ns) - 1
            # the latest span to open before the launch, or the ancestor
            # of it still open then
            i = order[k] if k >= 0 else -1
            while i >= 0 and not recs[i].end_ns >= t_ns:
                i = recs[i].parent
            if i >= 0:
                name = recs[i].name
        sec = 1e-6 * (e.time_range.end - e.time_range.start)
        out[name] = out.get(name, 0.0) + sec
    return out
