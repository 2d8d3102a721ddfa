"""Structured metrics: per-phase timings and throughput counters, as the
JAX package's ``utils/metrics.py``, with one JSON-able summary.

A phase on the card is timed by CUDA events recorded on the current
stream around it, read after the end event completes, so queued device
work counts; elsewhere by the host clock, after waiting for the phase's
output (``box["out"]``) where it lives on the card. Under several ranks
only rank 0 prints (``MetricsLogger.log``, ``phase_timer``).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict

import torch

from pathtracerpython_tpu_torch.parallel.multihost import is_primary

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
    """Seconds of a phase: CUDA events on a card, else the host clock."""

    def __init__(self, device):
        self.cuda = _cuda_device(device)
        if self.cuda is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record(torch.cuda.current_stream(self.cuda))
        else:
            self.t0 = time.perf_counter()

    def seconds(self, out=None) -> float:
        if self.cuda is not None:
            self.end.record(torch.cuda.current_stream(self.cuda))
            self.end.synchronize()
            return self.start.elapsed_time(self.end) / 1e3
        _sync_outputs(out)
        return time.perf_counter() - self.t0


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
            self.timings[phase] += clock.seconds(box.get("out"))
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
        if is_primary():
            printer(json.dumps(self.summary(), sort_keys=True))


@contextlib.contextmanager
def phase_timer(name: str, log=print, device=None):
    """A standalone phase timer under a ``torch.profiler`` annotation; on a
    CUDA ``device`` timed by events, else by the host clock; rank 0
    prints."""
    with torch.profiler.record_function(name):
        clock = _Clock(device)
        yield
        seconds = clock.seconds()
        if is_primary():
            log(f"[{name}] {seconds:.3f}s")
