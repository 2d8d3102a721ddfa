"""Structured metrics: per-phase timings and throughput counters, as the
JAX package's ``utils/metrics.py``, with one JSON-able summary; and the
spans and counters the package records inside its own phases while a
``torch.profiler`` is recording.

A phase on the card is timed by CUDA events recorded on the current
stream around it, read after the end event completes, so queued device
work counts; elsewhere by the host clock, after waiting for the phase's
output (``box["out"]``) where it lives on the card. Under several ranks
only rank 0 prints (``MetricsLogger.log``).

``span(name)`` and ``count(name, value)`` mark the package's phases
(``ptt.chunk``, ``ptt.bounce``, ``ptt.rng``, ...) and count their work.
With no profiler recording, ``span`` hands back one shared null context
and ``count`` returns at once: no event, no annotation, no reduction.
Under a profiler a span is a ``record_function`` annotation (on the host
and the device timelines of the Chrome trace, on the kernels' clock) with
a CUDA timing event at either end (the host clock where CUDA is not in
use), its parent taken from the thread's open spans; nothing is read back
until ``report()``, after the profiled stretch. A stretch begins at the
first span or count under a profiler after a span opened with none on
the thread that began the last one (a thread the profiler does not follow
records nothing), or after a ``report()``, or at ``RECORDER.begin()``.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict

import torch


def _cuda_device(device) -> torch.device | None:
    """``device`` as a CUDA device, or None when it is not one."""
    if device is None:
        return None
    device = torch.device(device)
    return device if device.type == "cuda" else None


def _sync_outputs(out) -> None:
    """Wait for the card work behind ``out`` (tensors, or containers of
    them)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _sync_outputs(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _sync_outputs(v)


class _Clock:
    """Seconds of a phase: CUDA events on a card, else the host clock.
    Made at the phase's start; ``stop`` records its end without waiting
    for the card, ``seconds`` reads it."""

    def __init__(self, device):
        self.cuda = _cuda_device(device)
        if self.cuda is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.cuda))
        else:
            self.t0 = time.perf_counter()

    def stop(self, out=None) -> None:
        """Record the end; on the host clock after waiting for ``out``."""
        if self.cuda is not None:
            self.end.record(torch.cuda.current_stream(self.cuda))
        else:
            _sync_outputs(out)
            self.t1 = time.perf_counter()

    def seconds(self) -> float:
        if self.cuda is not None:
            self.end.synchronize()
            return self.start.elapsed_time(self.end) / 1e3
        return self.t1 - self.t0


class MetricsLogger:
    """Accumulates counters and phase timings; ``summary()`` is JSON-able."""

    def __init__(self):
        self.counters: dict[str, float] = defaultdict(float)
        self.timings: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += value

    @contextlib.contextmanager
    def timed(self, phase: str, device=None):
        """Time a phase. On a CUDA ``device`` by events around it; else by
        the host clock after waiting for the phase's output, ``box["out"]``,
        so that queued card work does not make the phase look free."""
        clock = _Clock(device)
        box = {}
        try:
            yield box
        finally:
            clock.stop(box.get("out"))
            self.timings[phase] += clock.seconds()
            self.calls[phase] += 1

    def rate(self, counter: str, phase: str) -> float:
        dt = self.timings.get(phase, 0.0)
        return self.counters.get(counter, 0.0) / dt if dt > 0 else 0.0

    def summary(self) -> dict:
        return {
            "counters": dict(self.counters),
            "timings_s": dict(self.timings),
            "calls": dict(self.calls),
        }

    def log(self, printer=print) -> None:
        from pathtracerpython_tpu_torch.parallel.multihost import is_primary

        if is_primary():
            printer(json.dumps(self.summary(), sort_keys=True))


_NULL = contextlib.nullcontext()


class _Span:
    """One span of the stretch: its name, its parent on its thread, its
    annotation, its clock and its host start and end."""

    __slots__ = ("rec", "name", "parent", "fn", "clock", "t0", "t1")

    def __init__(self, rec: Recorder, name: str):
        self.rec = rec
        self.name = name
        self.t1 = None

    def __enter__(self):
        rec = self.rec
        stack = rec.stack()
        self.parent = stack[-1] if stack else None
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        self.t0 = time.perf_counter()
        self.clock = _Clock("cuda" if torch.cuda.is_initialized() else None)
        stack.append(self)
        rec.spans.append(self)
        return self

    def __exit__(self, *exc):
        self.clock.stop()
        self.t1 = time.perf_counter()
        self.rec.stack().pop()
        self.fn.__exit__(*exc)
        return False


class Recorder:
    """The spans and counters of the last profiled stretch (see the
    module's docstring); the package records into ``RECORDER``."""

    def __init__(self):
        self._local = threading.local()
        self._open = False      # a stretch is being recorded
        self._owner = None      # the thread that began it
        self.spans: list[_Span] = []
        self.counts: list[tuple[str, object]] = []
        self._report: dict | None = None

    def stack(self) -> list:
        """This thread's open spans, innermost last."""
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def _begin(self) -> None:
        if not self._open:
            self.begin()

    def begin(self) -> None:
        """Start a stretch now, with nothing in it."""
        self._open, self._owner = True, threading.get_ident()
        self.spans, self.counts, self._report = [], [], None

    def span(self, name: str):
        """A context manager marking the phase ``name``."""
        if not torch.autograd._profiler_enabled():
            if self._open and threading.get_ident() == self._owner:
                self._open = False
            return _NULL
        self._begin()
        return _Span(self, name)

    def count(self, name: str, value) -> None:
        """Add ``value`` (a number, or a tensor whose sum is kept on its
        device) to the counter ``name``."""
        if not torch.autograd._profiler_enabled():
            return
        self._begin()
        if isinstance(value, torch.Tensor):
            value = value.sum()
        self.counts.append((name, value))

    def report(self) -> dict:
        """The stretch's totals, and the end of the stretch: ``{"spans":
        {name: {"count", "host_s", "device_s", "device_self_s"}},
        "counters": {name: total}}``. A span's device seconds run from its
        start event to its end event; its self-seconds are those less its
        children's on its thread. Open spans are left out."""
        self._open = False
        if self._report is not None:
            return self._report
        done = [s for s in self.spans if s.t1 is not None]
        device = {id(s): s.clock.seconds() for s in done}
        inner = defaultdict(float)
        for s in done:
            if s.parent is not None:
                inner[id(s.parent)] += device[id(s)]
        spans: dict[str, dict] = {}
        for s in done:
            tot = spans.setdefault(s.name, {"count": 0, "host_s": 0.0,
                                            "device_s": 0.0,
                                            "device_self_s": 0.0})
            tot["count"] += 1
            tot["host_s"] += s.t1 - s.t0
            tot["device_s"] += device[id(s)]
            tot["device_self_s"] += device[id(s)] - inner[id(s)]
        counters: dict[str, float] = defaultdict(int)
        for name, v in self.counts:
            counters[name] += v.item() if isinstance(v, torch.Tensor) else v
        self._report = {"spans": spans, "counters": dict(counters)}
        return self._report


RECORDER = Recorder()
span = RECORDER.span
count = RECORDER.count
report = RECORDER.report
