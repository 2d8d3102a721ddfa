"""The system's own spans and counters of a cell's traced stretch
(``pathtracerpython_tpu_torch.utils.metrics.report()``), a unit of work at
a time.

The readers divide by the stretch's count of the unit's span (``ptt.chunk``
for a render's chunk, ``ptt.step`` for a training step) and read None where
that count differs from the traced units, so that a miscount shows as a
missing metric and not as a wrong one; and None where the system records
no such span or counter (a version without them).
"""

from __future__ import annotations


def report() -> dict | None:
    """The system's totals of its last profiled stretch, or None where it
    keeps none."""
    from pathtracerpython_tpu_torch.utils import metrics

    read = getattr(metrics, "report", None)
    return None if read is None else read()


def _counted(summary: dict, unit: str) -> dict | None:
    """The report, where it holds one ``unit`` span per traced unit."""
    rep = report()
    if rep is None:
        return None
    if rep["spans"].get(unit, {}).get("count") != summary["units"]:
        return None
    return rep


def self_ms(summary: dict, name: str, unit: str) -> float | None:
    """Device self-milliseconds a unit of the spans ``name``: from each
    one's start event to its end event, less its children's."""
    rep = _counted(summary, unit)
    if rep is None or name not in rep["spans"]:
        return None
    return rep["spans"][name]["device_self_s"] / summary["units"] * 1e3


def dead_share(summary: dict, unit: str) -> float | None:
    """100 x (1 - live_lane_bounces / lane_bounces), in %."""
    rep = _counted(summary, unit)
    if rep is None:
        return None
    lanes = rep["counters"].get("lane_bounces", 0)
    if lanes <= 0:
        return None
    return 100.0 * (1.0 - rep["counters"].get("live_lane_bounces", 0)
                    / lanes)
