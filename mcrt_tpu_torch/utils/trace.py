"""Spans and counters of the port's host work, into a render's `stats` dict
and onto torch.profiler's own clock.

    with trace.recording(stats):        # render() opens it when given a dict
        with trace.span("render.chunk"):
            ...
        trace.count("loop_steps", steps)

`span(name)` times a stretch of host work. While `recording(stats)` is open
it adds to `stats["spans"][name] = [count, seconds, self seconds]`, timed
with `time.perf_counter_ns`: the self time is the duration less what the
span's child spans (those opened inside it, on this thread) cover. While a
torch.profiler is on, recording or not, it also opens a host range of that
name (`_RecordFunctionFast`), which lands in the profile as a CPU op nested
in its parent's and shares the profile's clock with every kernel. It never
lands as a CUDA-typed event: `torch.profiler.record_function` opens a user
annotation, for which kineto adds a `gpu_user_annotation` over the kernels
launched inside it, and those would read as device time. With neither on,
`span` returns one shared context that does nothing and reads no clock.

`count(name, n)` adds `n` to the flat `stats[name]` while recording.

A span is host time: no span goes inside a step that is captured as a CUDA
graph (a replay runs none of its Python), so work done once a step is
counted, not spanned.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch._C._profiler import _RecordFunctionFast as _HostRange

_clock = time.perf_counter_ns


class _Recorder(threading.local):
    stats = None     # the dict recording() opened on this thread, or None
    open = None      # the spans open under it, innermost last


_rec = _Recorder()


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class _Null:
    """The span that records nothing: neither recording nor profiling."""
    seconds = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    """A span that records (`seconds` is its duration once it closed) or
    only opens a profiler range, or both."""
    __slots__ = ("name", "range", "stats", "t0", "child_ns", "seconds")

    def __init__(self, name: str):
        self.name = name
        self.range = self.stats = self.seconds = None

    def __enter__(self):
        if _profiling():
            self.range = _HostRange(self.name)
            self.range.__enter__()
        self.stats = _rec.stats
        if self.stats is not None:
            _rec.open.append(self)
            self.child_ns = 0
            self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        if self.stats is not None:
            ns = _clock() - self.t0
            _rec.open.pop()
            if _rec.open:
                _rec.open[-1].child_ns += ns
            self.seconds = ns * 1e-9
            rec = self.stats.setdefault("spans", {}).setdefault(self.name, [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += self.seconds
            rec[2] += (ns - self.child_ns) * 1e-9
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context that times its body as the span `name` (see the module's
    docstring)."""
    if _rec.stats is None and not _profiling():
        return _NULL
    return _Span(name)


def count(name: str, n=1):
    """Add `n` to `stats[name]` of the open recording, if any."""
    stats = _rec.stats
    if stats is not None:
        stats[name] = stats.get(name, 0) + n


def now() -> int:
    """The recorder's clock in ns while recording, else 0 (no clock read)."""
    return _clock() if _rec.stats is not None else 0


@contextlib.contextmanager
def recording(stats: dict | None):
    """Record spans and counters into `stats` on this thread over the body;
    with None, change nothing."""
    if stats is None:
        yield
        return
    saved = _rec.stats, _rec.open
    _rec.stats, _rec.open = stats, []
    try:
        yield
    finally:
        _rec.stats, _rec.open = saved
