"""What every cell shares: finding its parts by name, the window's
arithmetic, the device's description, the import check and the result line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
configuration's file is the one its entry names; a traffic mix is
``traffic/<name>.json`` and names its driver, ``drivers/<name>.py``; a
per-layer metric is read by ``metrics/<name>.py``. Adding any of them adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "pathtracerpython_tpu_torch"
# Whole top-level module names that may not be loaded by the end of a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "pathtracerpython_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(name: str, bench: dict | None = None, root: str = ROOT):
    """(the workload's entry, its configuration, its traffic mix)."""
    bench = bench or benchmark(root)
    wl = find(bench["workloads"], name, "workload")
    cfg_entry = find(bench["configs"], wl["config"], "config")
    config = load_json(os.path.join(root, cfg_entry["file"]))
    return wl, config, traffic(wl["traffic"])


def traffic(name: str) -> dict:
    return load_json(os.path.join(HERE, "traffic", f"{name}.json"))


def driver(name: str):
    """The driver module ``drivers/<name>.py``."""
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str):
    """``read(summary) -> float | None`` of ``metrics/<name>.py`` (names
    may hold dots, so the file is loaded by its path)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, wl_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
    that list it, and those without a list whose moved metric it reports."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or wl_name in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (wl_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def limits(wl_name: str) -> dict:
    """The limits of the numbers the cell's check compares,
    ``limits/<cell>.json``."""
    return load_json(os.path.join(HERE, "limits", f"{wl_name}.json"))


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value with at least
    q% of the values at or below it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(s)))
    return s[k - 1]


def loaded_forbidden() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def program_inside_checkout(module) -> bool:
    """Whether the imported system comes from this checkout."""
    path = os.path.realpath(getattr(module, "__file__", "") or "")
    return path.startswith(os.path.realpath(ROOT) + os.sep)


def power_limit_w() -> float | None:
    """The card's power limit in watts, from nvidia-smi (None: unread)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_info(chips: int) -> dict:
    import torch

    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak),
            "power_limit_w": power_limit_w()}


def check_lines(checks: list[tuple]) -> list[str]:
    return [f"check {name} {value!r} limit {limit!r}"
            for name, value, limit in checks]


def is_correct(checks: list[tuple]) -> bool:
    """Every compared number is finite and within its limit."""
    return bool(checks) and all(
        isinstance(v, (int, float)) and math.isfinite(v) and v <= lim
        for _, v, lim in checks)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: list[tuple],
                breakdown: dict | None = None) -> str:
    """The last line of a run: ``checks`` comes last, each number compared
    beside its limit."""
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return json.dumps(_finite(out), allow_nan=False)


def _finite(x):
    """``x`` with every non-finite float as null: the line stays JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x
