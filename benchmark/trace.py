"""A profiled stretch of a cell's work and the summary its readers take.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (host ops and the
card's activity), writes the Chrome trace into a fresh directory under
``TMPDIR`` for the length of the parse, and deletes it. The summary holds:
the traced window's seconds; the device busy seconds (the union of kernel,
copy and fill intervals); the device seconds of every kernel by name; those
of the system's own CUDA kernels (told apart by the ``__global__`` names in
its ``csrc/``) in families; the device seconds of kernels launched from
inside autograd's backward; and the idle gaps of the device, each named by
the host op that launched the work that ended it.
"""

from __future__ import annotations

import bisect
import glob
import json
import os
import re
import shutil
import tempfile
import time

# The system's kernels of each family, by their __global__ names.
FAMILIES = {
    "nearest": ("nearest_kernel", "sparse_nearest_kernel",
                "walker_nearest_kernel"),
    "anyhit": ("nee_kernel", "any_hit_kernel", "sparse_any_hit_kernel",
               "sparse_any_hit_idx_kernel", "blocking_cluster_kernel",
               "walker_any_hit_kernel"),
}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BACKWARD_OP = "autograd::engine::evaluate_function"
NAME_CHARS = 160


def port_kernel_names(package_dir: str) -> set[str]:
    """The ``__global__`` function names of the system's CUDA sources."""
    names = set()
    pattern = re.compile(
        r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")
    for path in glob.glob(os.path.join(package_dir, "csrc", "*.cu")):
        with open(path) as f:
            names.update(pattern.findall(f.read()))
    return names


def _matcher(names) -> re.Pattern:
    alt = "|".join(sorted(map(re.escape, names), key=len, reverse=True))
    return re.compile(rf"(?:^|[\s:*&])({alt})\s*[<(]")


def profile(fn, sync) -> tuple[dict, float]:
    """(the Chrome trace's events, the traced window's seconds) of
    ``fn()``; ``sync()`` waits for the device on both sides."""
    import torch
    from torch.profiler import ProfilerActivity

    sync()
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            fn()
            sync()
            window = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        p.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return events, window


def summarize(events: list, window_s: float, port_names: set[str]) -> dict:
    """The summary of a trace (see the module's docstring); times in s."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    runtime = {e["args"]["correlation"]: e for e in events
               if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
               and "correlation" in e.get("args", {})}
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") == "cpu_op"]
    port = _matcher(port_names) if port_names else None
    fam = {k: _matcher(v) for k, v in FAMILIES.items()}

    def index(lst):
        """Ops by thread, sorted by start, with their starts."""
        out: dict = {}
        for e in lst:
            out.setdefault(e["tid"], []).append(e)
        for v in out.values():
            v.sort(key=lambda e: e["ts"])
        return {tid: (v, [e["ts"] for e in v]) for tid, v in out.items()}

    all_ops = index(ops)
    bwd_ops = index([e for e in ops if e["name"].startswith(BACKWARD_OP)])

    def enclosing(table, tid, ts):
        """The innermost op of ``table`` on thread ``tid`` running at
        ``ts``: of those started by then, the latest that has not ended."""
        lst, st = table.get(tid, ([], []))
        for e in reversed(lst[max(0, bisect.bisect_right(st, ts) - 4096):
                              bisect.bisect_right(st, ts)]):
            if ts <= e["ts"] + e["dur"]:
                return e
        return None

    kernel_s: dict = {}
    family_s = {k: 0.0 for k in FAMILIES}
    port_s = all_kernel_s = backward_s = 0.0
    for e in dev:
        if e["cat"] != "kernel":
            continue
        s = e["dur"] * 1e-6
        name = e["name"]
        kernel_s[name[:NAME_CHARS]] = kernel_s.get(name[:NAME_CHARS], 0.0) + s
        all_kernel_s += s
        if port is not None and port.search(name):
            port_s += s
            for k, m in fam.items():
                if m.search(name):
                    family_s[k] += s
        launch = runtime.get(e.get("args", {}).get("correlation"))
        if launch is not None and enclosing(bwd_ops, launch["tid"],
                                            launch["ts"]) is not None:
            backward_s += s

    spans = [(e["ts"], e["ts"] + e["dur"], e)
             for e in sorted(dev, key=lambda e: e["ts"])]
    busy_us = 0.0
    gaps: dict = {}
    end = None
    for a, b, e in spans:
        if end is None:
            busy_us += b - a
            end = b
            continue
        if a > end:
            launch = runtime.get(e.get("args", {}).get("correlation"))
            host = None
            if launch is not None:
                op = enclosing(all_ops, launch["tid"], launch["ts"])
                host = op["name"] if op is not None else launch["name"]
            key = (host or "unknown")[:NAME_CHARS]
            gaps[key] = gaps.get(key, 0.0) + (a - end) * 1e-6
            busy_us += b - a
            end = b
        elif b > end:
            busy_us += b - end
            end = b
    return {
        "window_s": window_s,
        "busy_s": busy_us * 1e-6,
        "kernel_s": kernel_s,
        "family_s": family_s,
        "port_kernel_s": port_s,
        "all_kernel_s": all_kernel_s,
        "backward_s": backward_s,
        "idle_gaps": gaps,
    }


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps' time
    by the host op running in them, ten of each, in seconds."""
    ops = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
