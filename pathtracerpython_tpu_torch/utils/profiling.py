"""Profiler hooks on ``torch.profiler`` (the JAX package's
``utils/profiling.py`` on ``jax.profiler``): a trace of a code region,
written as a Chrome trace that Perfetto opens, beside the totals of the
package's own spans and counters in it (``utils.metrics.report``).

Usage::

    with trace_context("/tmp/trace") as prof:
        render(...)
    # /tmp/trace/trace.json, /tmp/trace/spans.json; prof.key_averages()
    # for a table
"""

from __future__ import annotations

import contextlib
import json
import os

import torch
from torch.profiler import ProfilerActivity, profile

from pathtracerpython_tpu_torch.utils.metrics import RECORDER


@contextlib.contextmanager
def trace_context(log_dir: str):
    """Profile the region (host ops, and the card's kernels where CUDA is
    available); on exit write ``log_dir/trace.json`` and the region's span
    and counter totals, ``log_dir/spans.json``. Yields the
    ``torch.profiler.profile``."""
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if torch.cuda.is_available()
                                           else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        RECORDER.begin()
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(RECORDER.report(), f, indent=1, sort_keys=True)
